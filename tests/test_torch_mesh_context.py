"""The port's config, context, mesh of ranks and launchers
(`analytics_zoo_tpu_torch/common/{config,context,mesh,cluster,launch}.py`)
held against the JAX package's: the axis inference and the kwarg errors
case for case, the mesh's rank layout against the JAX mesh's device
layout on the conftest's virtual devices, and the mesh's collectives on
4 gloo CPU ranks (one group, spawned once for the module), a `zoo-launch`
of 2 CPU ranks, and the static import scan of the new modules."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common import context as jcontext
from analytics_zoo_tpu.common import mesh as jmesh
from analytics_zoo_tpu_torch.common import config as tconfig
from analytics_zoo_tpu_torch.common import context as tcontext
from analytics_zoo_tpu_torch.common import mesh as tmesh
from analytics_zoo_tpu_torch.common.cluster import (ProcessMonitor,
                                                    launch_local_cluster)

from torch_dist_workers import run_group

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "analytics_zoo_tpu_torch"

AXIS_CASES = [
    (8, dict()), (8, dict(data=2, fsdp=-1)), (8, dict(data=2, fsdp=2, tensor=2)),
    (4, dict(data=1, fsdp=-1)), (4, dict(pipeline=2, data=-1)),
    (1, dict()), (6, dict(data=-1, sequence=3)),
    # the errors
    (8, dict(data=3)), (8, dict(data=-1, fsdp=-1)), (8, dict(data=-1, fsdp=3)),
    (8, dict(data=0)), (8, dict(data=2, fsdp=2)),
]


def _outcome(fn):
    try:
        return fn()
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n,axes", AXIS_CASES)
def test_infer_axis_sizes_case_for_case(n, axes):
    assert _outcome(lambda: tmesh._infer_axis_sizes(
        n, tconfig.MeshConfig(**axes))) == _outcome(
        lambda: jmesh._infer_axis_sizes(n, jconfig.MeshConfig(**axes)))
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES


@pytest.mark.parametrize("kwargs", [
    dict(bogus_axis=2), dict(data=1, tensr=2), dict(executor_cores=4),
    dict(cluster_mode="nowhere"), dict(cluster_mode="multi-host"),
])
def test_init_orca_context_kwarg_errors(kwargs, monkeypatch):
    """The same kwarg errors as the JAX package: an unknown kwarg is a
    TypeError naming the mesh axes, an unknown mode a ValueError, a
    multi-host mode without a coordinator a ValueError; a Spark kwarg is
    accepted."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    prev_j, prev_t = jcontext._GLOBAL["context"], tcontext._GLOBAL["context"]
    try:
        j = _outcome(lambda: jcontext.init_orca_context(**kwargs) and None)
        t = _outcome(lambda: tcontext.init_orca_context(
            device="cpu", **kwargs) and None)
    finally:
        jcontext._GLOBAL["context"] = prev_j
        tcontext._GLOBAL["context"] = prev_t
    assert (t is None) == (j is None)
    if j is not None:
        assert t[0] == j[0]
        if j[0] == "TypeError":
            assert t[1] == j[1]


def test_local_context_is_one_rank_and_exported():
    import analytics_zoo_tpu_torch as zoo
    ctx = zoo.init_orca_context(cluster_mode="local", device="cpu",
                                data=-1)
    try:
        assert zoo.init_orca_context is tcontext.init_orca_context
        assert ctx.mesh.world == 1 and not ctx.mesh.distributed
        assert ctx.mesh.axis_sizes["data"] == 1
        assert repr(ctx.mesh) == "DeviceMesh(single-device)"
        assert tcontext.get_context() is ctx
        t = torch.arange(4.0)
        assert ctx.mesh.all_reduce(t) is t
        assert ctx.mesh.permute(t, "sequence") is t
        assert isinstance(ctx.next_rng(), int)
    finally:
        zoo.stop_orca_context()
    assert tcontext.current_context() is None


def test_config_env_overrides_match(monkeypatch, tmp_path):
    for k, v in {"ZOO_MESH_FSDP": "4", "ZOO_MESH_DATA": "1",
                 "ZOO_SHARDED_FIT": "1", "ZOO_NUM_PROCESSES": "2",
                 "ZOO_PROCESS_ID": "1", "ZOO_SEED": "5"}.items():
        monkeypatch.setenv(k, v)
    j, t = jconfig.ZooConfig.from_env(), tconfig.ZooConfig.from_env()
    jd, td = j.to_dict(), t.to_dict()
    td.pop("device")
    jd.pop("serving"), td.pop("serving")
    assert td == jd
    t.save(str(tmp_path / "c.json"))
    assert tconfig.ZooConfig.load(str(tmp_path / "c.json")).mesh.fsdp == 4
    monkeypatch.setenv("ZOO_DEVICE", "cpu")
    assert tconfig.ZooConfig.from_env().device == "cpu"


@pytest.mark.parametrize("axes", [dict(data=2, fsdp=2),
                                  dict(pipeline=2, data=2),
                                  dict(data=1, sequence=4)])
def test_rank_layout_is_the_jax_device_layout(axes, devices8):
    """Rank r of the port's mesh sits where device r sits in the JAX
    mesh (row-major over AXIS_NAMES)."""
    jm = jmesh.DeviceMesh(jconfig.MeshConfig(**axes), devices8[:4])
    grid = np.vectorize(lambda d: d.id)(jm.mesh.devices)
    sizes = tmesh._infer_axis_sizes(4, tconfig.MeshConfig(**axes))
    shape = tuple(sizes[a] for a in tmesh.AXIS_NAMES)
    ids = [d.id for d in devices8[:4]]
    for r in range(4):
        coords = np.unravel_index(r, shape)
        assert grid[coords] == ids[r]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group("mesh_worker", 4, str(tmp_path_factory.mktemp("mesh")))


def test_collectives_on_four_gloo_ranks(group):
    base = [np.arange(6) + 10 * r for r in range(4)]
    # data=2 x fsdp=2: rank = 2 * data + fsdp
    for r, res in enumerate(group):
        d, f = divmod(r, 2)
        assert res["coords"]["data"] == d and res["coords"]["fsdp"] == f
        assert res["batch_index"] == r and res["backend"] == "gloo"
        np.testing.assert_array_equal(res["sum_batch"], sum(base))
        np.testing.assert_array_equal(res["sum_data"],
                                      base[f] + base[2 + f])
        np.testing.assert_array_equal(res["sum_fsdp"],
                                      base[2 * d] + base[2 * d + 1])
        np.testing.assert_array_equal(res["max_all"], base[3])
        np.testing.assert_array_equal(
            res["gather_fsdp0"], np.repeat([2 * d, 2 * d + 1], 2)[:, None]
            * np.ones((4, 3)))
        np.testing.assert_array_equal(
            res["gather_data1"], np.repeat([f, 2 + f], 3)[None, :]
            * np.ones((2, 6)))
        full = np.arange(12).reshape(3, 4) * ((2 * d + 1) + (2 * d + 2))
        np.testing.assert_array_equal(res["scatter_fsdp1"],
                                      full[:, 2 * f:2 * f + 2])
        assert res["hop_fsdp"].item() == 2 * d + (1 - f)
        assert res["hop_data_back"].item() == 2 * (1 - d) + f
        assert res["hop_sequence"].item() == r
        np.testing.assert_array_equal(res["ints"],
                                      [[i, 7 * i] for i in range(4)])
        assert res["ring_coords"]["sequence"] == r
        assert res["ring_hop"].item() == (r - 1) % 4


def test_routes_and_counts(group):
    res = group[0]
    assert res["routes"] == tmesh.COLLECTIVE_ROUTES[("gloo", "cpu")]
    assert tmesh.COLLECTIVE_ROUTES[("gloo", "cuda")]["permute"] == "host"
    assert set(tmesh.route_table()) == {"nccl/cuda", "gloo/cpu",
                                        "gloo/cuda"}
    stats = res["stats"]
    assert stats["all_reduce"]["calls"] == 4
    assert stats["permute"]["calls"] == 3      # the size-1 hop is no call
    assert all(v["host_staged"] == 0 for v in stats.values())


def test_cluster_refusals_and_fail_fast(tmp_path):
    with pytest.raises(ValueError, match="one rank on one device"):
        launch_local_cluster("m:f", 2, devices_per_process=2)
    with pytest.raises(ValueError, match="platform"):
        launch_local_cluster("m:f", 2, platform="tpu")
    ok = subprocess.Popen([sys.executable, "-c", "import time; "
                           "time.sleep(30)"])
    bad = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(RuntimeError, match="exited with 3"):
        ProcessMonitor([ok, bad]).wait(timeout=20)
    assert ok.poll() is not None


def test_zoo_launch_two_cpu_ranks(tmp_path):
    """`zoo-launch --simulate-devices 2` runs a script on 2 CPU ranks that
    rendezvous through a file store and all-reduce."""
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, torch\n"
        "import analytics_zoo_tpu_torch as zoo\n"
        "ctx = zoo.init_orca_context(cluster_mode='multi-host')\n"
        "m = ctx.mesh\n"
        "t = m.all_reduce(torch.tensor([float(m.rank + 1)]))\n"
        "open(sys.argv[1] + f'/r{m.rank}', 'w').write(\n"
        "    f'{m.world} {m.device} {m.backend} {t.item()}')\n"
        "zoo.stop_orca_context()\n")
    from analytics_zoo_tpu_torch.common import launch
    cmds = launch.build_commands(["localhost"], 1, "c:1", str(script), [],
                                 simulate_devices=2)
    assert [c[1]["ZOO_PROCESS_ID"] for c in cmds] == ["0", "1"]
    assert all(c[1]["ZOO_DEVICE"] == "cpu" for c in cmds)
    res = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.common.launch",
         "--simulate-devices", "2", "--timeout", "60", str(script),
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=90)
    assert res.returncode == 0, res.stderr[-2000:]
    for r in range(2):
        assert (tmp_path / f"r{r}").read_text() == "2 cpu gloo 3.0"


_NEW = ["common/config.py", "common/context.py", "common/mesh.py",
        "common/cluster.py", "common/launch.py", "parallel/__init__.py",
        "parallel/sharding.py", "parallel/ring_attention.py",
        "parallel/pipeline.py"]


def test_new_modules_import_no_jax():
    """The static scan of `test_torch_flash_attention.py` over the
    distributed slice's modules: no jax, nothing of the JAX package."""
    forbidden = {"jax", "jaxlib", "analytics_zoo_tpu", "tensorflow"}
    for rel in _NEW:
        tree = ast.parse((PORT / rel).read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add((node.module or "").split(".")[0])
        assert not roots & forbidden, (rel, roots & forbidden)
        assert "analytics_zoo_tpu/" in (PORT / rel).read_text()[:600], rel
