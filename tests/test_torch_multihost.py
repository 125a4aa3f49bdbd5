"""The port's process-group layer (`madrigal_tpu_torch/parallel/
multihost.py`, `mesh.py`) with real separate processes, as
tests/test_multihost.py does for the JAX package: four gloo ranks on the
CPU, laid out as 2 hosts of 2 (LOCAL_WORLD_SIZE=2). The workers import no
JAX (they start as `python -c`); they write their results to `tmp_path`
and the pytest process checks them.

  * `_balanced_factors` equals the JAX package's for n <= 64, k <= 3.
  * `hybrid_mesh`: dp across the 2 hosts, label inside a host, every dp
    row host-local; with 'label' as the cross-host axis the ranks are
    laid out accordingly; a pinned `ici_sizes` that does not divide a
    host raises.
  * `host_local_array` gives each rank its global offset and the global
    shape (ragged shards included); `gather_to_all_hosts` stacks every
    rank's array in rank order; `sync_hosts` returns; `initialize` is a
    no-op once the group is up.
"""
import json
import os
import sys

import numpy as np
import pytest

from madrigal_tpu.parallel.multihost import _balanced_factors as j_factors
from madrigal_tpu_torch.parallel.dryrun import launch, require_ok
from madrigal_tpu_torch.parallel.multihost import _balanced_factors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from madrigal_tpu_torch.parallel import multihost as M
from madrigal_tpu_torch.parallel.mesh import axis_group, mesh_shape

dev = M.initialize(device="cpu")
assert M.initialize(device="cpu") == dev  # a no-op once initialized
rank = dist.get_rank()
out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
mesh = M.hybrid_mesh(("dp", "label"), dcn_axis="dp")
out["shape"] = mesh_shape(mesh)
out["layout"] = mesh.mesh.tolist()
out["dp_peers"] = dist.get_process_group_ranks(axis_group("dp", mesh))
out["label_peers"] = dist.get_process_group_ranks(axis_group("label", mesh))
flip = M.hybrid_mesh(("dp", "label"), dcn_axis="label")
out["flip_shape"] = mesh_shape(flip)
out["flip_layout"] = flip.mesh.tolist()
try:
    M.hybrid_mesh(("dp", "label"), ici_sizes={"label": 3})
    out["bad_ici"] = None
except ValueError as e:
    out["bad_ici"] = str(e)
host = rank // 2
rows = 8 if mesh.get_local_rank("dp") == 0 else 5
local = (np.arange(rows, dtype=np.float32) + 100 * host).reshape(rows, 1)
ha = M.host_local_array(mesh, ("dp",), local)
out["offset"], out["global_shape"] = ha.offset, list(ha.global_shape)
out["gathered"] = M.gather_to_all_hosts(
    np.full((2, 3), rank, np.float32)).tolist()
M.sync_hosts("test-done")
json.dump(out, open(sys.argv[1] + f"/rank{rank}.json", "w"))
M.shutdown()
"""


@pytest.mark.parametrize("k", [1, 2, 3])
def test_balanced_factors_match_jax(k):
    for n in range(1, 65):
        assert _balanced_factors(n, k) == j_factors(n, k), (n, k)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    res = launch([sys.executable, "-c", WORKER, str(root)], 4,
                 env={"LOCAL_WORLD_SIZE": "2", "OMP_NUM_THREADS": "1"},
                 timeout=240, cwd=ROOT)
    require_ok(res)
    return [json.load(open(root / f"rank{r}.json")) for r in range(4)]


def test_hybrid_mesh_puts_dp_across_hosts(four_ranks):
    for rank, out in enumerate(four_ranks):
        assert out["backend"] == "gloo" and out["world"] == 4
        assert out["shape"] == {"dp": 2, "label": 2}
        # dp row p holds host p's ranks: label traffic stays in a host
        assert out["layout"] == [[0, 1], [2, 3]]
        host = rank // 2
        assert out["label_peers"] == [2 * host, 2 * host + 1]
        assert out["dp_peers"] == [rank % 2, rank % 2 + 2]


def test_hybrid_mesh_other_cross_host_axis(four_ranks):
    for out in four_ranks:
        assert out["flip_shape"] == {"dp": 2, "label": 2}
        # 'label' crosses the hosts: a label column is one host's ranks
        assert out["flip_layout"] == [[0, 2], [1, 3]]
        assert "does not divide the per-host device count 2" in (
            out["bad_ici"])


def test_host_local_array_offsets(four_ranks):
    for rank, out in enumerate(four_ranks):
        # dp coordinate 0 holds 8 rows, 1 holds 5: host 1's rows follow
        assert out["global_shape"] == [13, 1]
        assert out["offset"] == (0 if rank < 2 else 8)


def test_gather_to_all_hosts_stacks_in_rank_order(four_ranks):
    want = [[[r] * 3] * 2 for r in range(4)]
    for out in four_ranks:
        np.testing.assert_array_equal(np.asarray(out["gathered"]),
                                      np.asarray(want, np.float32))
