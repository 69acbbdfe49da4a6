"""The torch port's train mode and train step for the hybrid (zamba2),
VLM (llava) and encoder-decoder (whisper) families against the JAX
package, on the CPU.

Per family, from the same weights and batches
(``test_torch_train.py``'s helpers and tolerances): one microbatch's
gradients of every parameter within 1e-5 of the tensor's largest
magnitude (the hybrid's shared block summed over its call sites, the
vlm's ``patch_proj`` through the patches, whisper's encoder through the
cross-attention), then the jitted reference's train step and the port's,
two microbatches.
"""

import pytest

from test_torch_train import check_gradients, check_train_step

ARCHS = ["zamba2-1.2b", "llava-next-34b", "whisper-base"]
# a weight each family reaches only through its own path
REACHED = {"zamba2-1.2b": "shared.attn.wq",
           "llava-next-34b": "patch_proj",
           "whisper-base": "encoder.0.attn.wq"}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    grads = check_gradients(arch)
    assert float(grads[REACHED[arch]].abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    met = check_train_step(arch)
    assert float(met["load_balance_loss"]) == 0.0
