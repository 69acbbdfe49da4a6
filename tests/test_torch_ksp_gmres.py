"""``ipi_gmres`` with ``-deterministic_dots`` and with ``-pc_type jacobi``
against the JAX reference: four families x both modes x both dtypes,
whole solves on the CPU, held to the rules of ``tests/test_torch_ksp.py``
(:func:`check_parity` states every tolerance and the gap it was measured
at).  The plain path is ``tests/test_torch_solve_gmres.py``'s; block
Jacobi is ``tests/test_torch_ksp_gmres_bjacobi.py``'s."""

import pytest

from test_torch_ksp import INSTANCES, check_parity

VARIANTS = {"deterministic_dots": dict(deterministic_dots=True),
            "jacobi": dict(pc_type="jacobi")}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ipi_gmres_variant_matches_reference(variant, family, mode, dtype):
    check_parity(family, mode, dtype, "ipi_gmres", **VARIANTS[variant])
