"""The torch port's train mode and train step for the MoE (olmoe, arctic)
and SSM (mamba2) families against the JAX package, on the CPU.

Per family, from the same weights and batches
(``test_torch_train.py``'s helpers and tolerances): one microbatch's
gradients of every parameter within 1e-5 of the tensor's largest
magnitude, through MoE's capacity dispatch and stable top-k, and through
the chunked SSD scan; the aux losses too; then the jitted reference's
train step and the port's, two microbatches.
"""

import pytest

from test_torch_train import check_gradients, check_train_step

ARCHS = ["olmoe-1b-7b", "arctic-480b", "mamba2-130m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    grads = check_gradients(arch)
    if arch != "mamba2-130m":
        # the experts and the router take gradients through the dispatch
        for leaf in ("router", "w_up", "w_down", "w_gate"):
            assert float(grads[f"blocks.0.moe.{leaf}"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    met = check_train_step(arch)
    moe = arch != "mamba2-130m"
    assert (float(met["load_balance_loss"]) > 0) == moe
    assert (float(met["router_z_loss"]) > 0) == moe
