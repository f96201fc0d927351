"""The plain PyTorch fused Tier-1 and CX/D scan against the JAX jnp
versions at plane budget L=5 (see tests/test_torch_t1.py for the
comparisons)."""
import pytest

from test_torch_t1 import check_cxd_scan_matches_jax, check_plain_matches_jax


@pytest.mark.parametrize("frac", [0, 7])
def test_plain_fused_t1_matches_jax_l5(frac):
    check_plain_matches_jax(5, frac)


@pytest.mark.parametrize("frac", [0, 7])
def test_plain_cxd_scan_matches_jax_l5(frac):
    check_cxd_scan_matches_jax(5, frac)
