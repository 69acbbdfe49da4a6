"""``ipi_gmres`` with ``-pc_type bjacobi`` against the JAX reference: four
families x both modes x both dtypes, whole solves on the CPU, held to the
rules of ``tests/test_torch_ksp.py`` (:func:`check_parity` states every
tolerance and the gap it was measured at)."""

import pytest

from test_torch_ksp import INSTANCES, check_parity


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_ipi_gmres_bjacobi_matches_reference(family, mode, dtype):
    check_parity(family, mode, dtype, "ipi_gmres", pc_type="bjacobi")
