"""The data-parallel step (``train_step(mesh=...)``) of the ``vup=True``
and silu flat-executor UNets on 2 and 4 gloo CPU ranks against JAX's
``shard_map`` step on 2 virtual devices (JAX lowers each of these fused
steps in interpret mode for 12-40 s a mesh size), and against the port's
one-process step on both rank counts, as
``tests/test_torch_parallel_step.py`` does (its helpers and
tolerances):

- ``vup``: ``UNet(vup=True)`` with three levels (JAX under
  ``E3TPU_VUP=1``, both vup kernels reached in interpret mode): the
  statistics of the never-stored upconv output (row 22) are summed over
  the ranks before the prologue, and their cotangents in row 23;
- ``silu``: the silu UNet's flat levels (``flat_batch_norm`` with the
  statistics of ``flat_conv3``, JAX's ``FlatBatchNorm(axis_name=...)``).
"""

import pytest

from test_torch_parallel_step import (check_jax, check_one_process,
                                      run_cases)

VUP = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
           planar_blocks=(0,), normalization="batch", pallas_flat=True)
SILU = dict(in_channels=1, out_channels=2, n_blocks=3, start_filts=32,
            planar_blocks=(0,), normalization="batch", activation="silu",
            pallas_flat=True)
CASES = {
    "vup": (dict(VUP, vup=True), VUP, (4, 2, 8, 8, 1), True),
    "silu": (SILU, SILU, (4, 4, 16, 16, 1), False),
}
JAX_AT = [("vup", 2), ("silu", 2)]
SPY = {"conv_bnact_flat_vup", "upconv122_stats_from_flat64", "conv_flat"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, JAX_AT, tmp_path_factory, 23, SPY)


@pytest.mark.parametrize("case, n", JAX_AT)
@pytest.mark.parametrize("what", ["loss", "grads", "batch_stats"])
def test_flat_data_parallel_step_matches_jax_shard_map(runs, case, n, what):
    check_jax(runs, case, n, what)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_flat_data_parallel_step_matches_one_process_step(runs, case, n):
    check_one_process(runs, case, n)


def test_flat_cases_reach_their_norm_sites(runs):
    """JAX reached its vup kernels and its flat conv; the port planned
    L0 and L1 on the kernels for vup, flat levels for silu (at 4 ranks:
    one row a rank)."""
    assert runs["seen"] == SPY
    assert runs["vup", 4]["ranks"][0]["vup"]["kinds"][:2] == ["kernels"] * 2
    assert "flat" in runs["silu", 4]["ranks"][0]["silu"]["kinds"]
