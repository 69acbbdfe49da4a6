"""``ipi_chebyshev`` and ``ipi_anderson`` against the JAX reference: four
families x both modes x both dtypes, whole solves on the CPU, held to the
rules of ``tests/test_torch_ksp.py`` (:func:`check_parity` states every
tolerance and the gap it was measured at).  Neither KSP takes a
preconditioner."""

import pytest

from test_torch_ksp import INSTANCES, check_parity


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["mincost", "maxreward"])
@pytest.mark.parametrize("family", sorted(INSTANCES))
@pytest.mark.parametrize("method", ["ipi_chebyshev", "ipi_anderson"])
def test_chebyshev_and_anderson_match_reference(method, family, mode,
                                                dtype):
    check_parity(family, mode, dtype, method)
