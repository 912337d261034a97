"""The port's persistent compile cache (`analytics_zoo_tpu_torch/
compile_cache/`) held against the JAX package's (`tests/test_compile_cache.py`
turned on the port's copy): the key anatomy beside the JAX functions on
the same numpy inputs, key invalidation (dtype, bucket, model), corruption
(truncated, garbage, wrong-version and flipped-bit entries are misses),
LRU eviction, prune and clear, the five registry families, the config
validation and wiring, the maintenance tool, racing writer processes, and
the kernel libraries of `kernels/_build.py` through the store with nvcc
and the loader replaced by fakes.

The port's entries are capture records and kernel libraries, never an
executable, so nothing here needs the JAX package's AOT path (which the
CPU builds of this repository refuse); the JAX key functions need none.
"""

import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.compile_cache import key as jkey
from analytics_zoo_tpu_torch.compile_cache import (CompileCache,
                                                   abstract_signature,
                                                   cheap_signature,
                                                   fingerprint, make_key,
                                                   model_fingerprint,
                                                   structure_signature)
from analytics_zoo_tpu_torch.compile_cache import store as ccstore
from analytics_zoo_tpu_torch.compile_cache import tool
from analytics_zoo_tpu_torch.kernels import _build
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
from analytics_zoo_tpu_torch.serving.inference_model import InferenceModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Scale(nn.Module):
    """`x * s` with `s` a buffer: the JAX tests' `load_fn(lambda p, x:
    x * p, np.float32(2.0))` as a module."""

    def __init__(self, s=2.0, dtype=torch.float32):
        super().__init__()
        self.register_buffer("s", torch.tensor(s, dtype=dtype))


def mul(p, x):
    return x * p.s


def add(p, x):
    return x + p.s


def warm(tmp_path, reg, fn=mul, dtype=np.float32, buckets=(4,), cache=None,
         module=None):
    cache = cache or CompileCache(str(tmp_path), registry=reg)
    im = InferenceModel(device="cpu", compile_cache=cache).load_fn(
        fn, module if module is not None else Scale())
    im.warmup(np.zeros((3,), dtype), buckets=list(buckets))
    return im


# ---------------------------------------------------------------------------
# key anatomy, beside the JAX functions
# ---------------------------------------------------------------------------
TREES = {
    "array": lambda: np.zeros((4, 3), np.float32),
    "list": lambda: [np.zeros((2, 16), np.int64), np.ones((2, 16), np.int32)],
    "auto-numbered dict": lambda: {
        "dense_3": {"kernel": np.zeros((4, 3), np.float32),
                    "bias": np.zeros((3,), np.float32)},
        "dense_10": {"kernel": np.zeros((3, 2), np.float32)},
        "embedding_1": np.zeros((10, 4), np.float16)},
    "nested": lambda: ({"b": np.zeros(2, np.int8), "a": None},
                       [np.float32(1.0), np.zeros((1, 1), np.uint8)]),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_signature_anatomy_matches_the_jax_functions(name):
    tree = TREES[name]()
    assert abstract_signature(tree) == jkey.abstract_signature(tree)
    assert structure_signature(tree) == jkey.structure_signature(tree)
    assert cheap_signature(tree) == jkey.cheap_signature(tree)
    sig = abstract_signature(tree)
    port = make_key("serving", "m", sig, placement="replicated")
    jax_ = jkey.make_key("serving", "m", jkey.abstract_signature(tree),
                         placement="replicated")
    for field in ("format", "kind", "model", "signature", "placement",
                  "sharding"):
        assert port.fields[field] == jax_.fields[field], field


def test_fingerprints_match_the_jax_functions():
    for obj in (mul, add, (1, "a", 2.5), {"x": np.zeros((2, 2))},
                lambda p, x: x * p):
        assert fingerprint(obj) == jkey.fingerprint(obj)
    assert fingerprint(mul) != fingerprint(add)


def test_a_tensor_signs_as_its_numpy_source():
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert abstract_signature([torch.from_numpy(a)]) == \
        abstract_signature([a])
    assert abstract_signature(torch.zeros(2, dtype=torch.bfloat16))[1] == \
        (((2,), "bfloat16"),)


def test_key_carries_the_torch_platform_and_the_dtype_rule():
    sig = abstract_signature(np.zeros((4, 3), np.float32))
    f32 = make_key("serving", "m", sig, device="cpu")
    assert {"torch", "cuda", "device_kind", "capability"} <= set(f32.fields)
    assert "jax" not in f32.fields and "backend" not in f32.fields
    assert f32.fields["torch"] == torch.__version__
    assert f32.fields["device_kind"] == "cpu"
    assert "dtype" not in f32.fields        # "" adds no field, as in JAX
    digests = {make_key("serving", "m", sig, dtype=d, device="cpu").digest
               for d in ("", "bfloat16", "int8")}
    assert len(digests) == 3


def test_model_fingerprint_follows_the_fn_and_the_module_structure():
    base = model_fingerprint(mul, Scale())
    assert model_fingerprint(mul, Scale(3.0)) == base   # values are inputs
    assert model_fingerprint(add, Scale()) != base
    assert model_fingerprint(mul, Scale(dtype=torch.bfloat16)) != base


# ---------------------------------------------------------------------------
# TestKeyInvalidation
# ---------------------------------------------------------------------------
def test_dtype_change_misses(tmp_path):
    reg = MetricsRegistry()
    warm(tmp_path, reg, dtype=np.float32)
    assert reg.get("compile_cache_misses_total").value() == 1
    warm(tmp_path, reg, dtype=np.int32)
    assert reg.get("compile_cache_misses_total").value() == 2
    im = warm(tmp_path, reg, dtype=np.float32)
    assert reg.get("compile_cache_hits_total").value() == 1
    assert im.warmup_source == {"3:b4": "cached"}


def test_serving_dtype_is_its_own_key_field(tmp_path):
    reg = MetricsRegistry()
    cc = CompileCache(str(tmp_path), registry=reg)
    f32 = warm(tmp_path, reg, cache=cc)
    bf16 = warm(tmp_path, reg, cache=cc,
                module=Scale(dtype=torch.bfloat16))
    assert bf16.serving_dtype == "bfloat16"
    assert bf16.warmup_source == {"3:b4": "compiled"}
    keys = [im._cache_key(abstract_signature(
        [torch.zeros((4, 3))])).fields for im in (f32, bf16)]
    assert "dtype" not in keys[0] and keys[1]["dtype"] == "bfloat16"
    assert cc.stats()["entries"] == 2


def test_bucket_is_its_own_entry(tmp_path):
    reg = MetricsRegistry()
    im = warm(tmp_path, reg, buckets=(2, 4))
    assert im.compile_cache.stats()["entries"] == 2
    warm(tmp_path, reg, buckets=(8,))
    assert reg.get("compile_cache_misses_total").value() == 3


def test_model_change_misses(tmp_path):
    reg = MetricsRegistry()
    cc = CompileCache(str(tmp_path), registry=reg)
    warm(tmp_path, reg, cache=cc, fn=mul)
    warm(tmp_path, reg, cache=cc, fn=add)
    assert reg.get("compile_cache_hits_total").value() == 0
    assert reg.get("compile_cache_misses_total").value() == 2


# ---------------------------------------------------------------------------
# TestCorruption: a bad entry is a miss, never an exception
# ---------------------------------------------------------------------------
def _one_entry(tmp_path, reg):
    warm(tmp_path, reg)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".aotc")]
    assert len(files) == 1
    return os.path.join(str(tmp_path), files[0])


def _truncate(path):
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)


def _garbage(path):
    with open(path, "wb") as fh:
        fh.write(b"\x00garbage" * 100)


def _future_version(path):
    blob = bytearray(open(path, "rb").read())
    struct.pack_into("<I", blob, 4, 99)
    open(path, "wb").write(bytes(blob))


def _flip_payload_bit(path):
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))


@pytest.mark.parametrize("damage", [_truncate, _garbage, _future_version,
                                    _flip_payload_bit])
def test_damaged_entry_is_a_miss_and_rewarms(tmp_path, damage):
    reg = MetricsRegistry()
    path = _one_entry(tmp_path, reg)
    damage(path)
    cc = CompileCache(str(tmp_path), registry=reg)
    key = make_key("serving", "whatever",
                   abstract_signature((np.zeros((4, 3), np.float32),)))
    assert cc.load(key) is None                   # never an exception
    im = warm(tmp_path, reg, cache=cc)            # no raise
    assert im.warmup_source == {"3:b4": "compiled"}
    assert reg.get("compile_cache_misses_total").value() >= 2
    np.testing.assert_array_equal(im.predict(np.ones((4, 3), np.float32)),
                                  np.full((4, 3), 2.0, np.float32))
    ccstore.read_entry(path)                      # rewritten, valid


# ---------------------------------------------------------------------------
# TestEviction
# ---------------------------------------------------------------------------
def test_lru_eviction_under_tiny_budget(tmp_path):
    reg = MetricsRegistry()
    probe = CompileCache(str(tmp_path / "probe"), registry=reg)
    warm(tmp_path, reg, cache=probe, buckets=(1,))
    entry_bytes = probe.stats()["bytes"]
    assert entry_bytes > 0
    cc = CompileCache(str(tmp_path / "lru"),
                      max_bytes=int(entry_bytes * 2.5), registry=reg)
    im = warm(tmp_path, reg, cache=cc, buckets=(1, 2, 4, 8))
    st = cc.stats()
    assert st["bytes"] <= int(entry_bytes * 2.5)
    assert 1 <= st["entries"] <= 2
    # warmup runs the largest bucket first; the survivors are the most
    # recently written, so bucket 1's entry is one of them
    digests = {e["digest"] for e in cc.index()}
    sig1 = abstract_signature(torch.zeros((1, 3)))
    assert im._cache_key(sig1).digest in digests


def test_prune_and_clear(tmp_path):
    reg = MetricsRegistry()
    cc = CompileCache(str(tmp_path), registry=reg)
    warm(tmp_path, reg, cache=cc, buckets=(1, 2, 4))
    assert cc.stats()["entries"] == 3
    cc.prune(max_bytes=cc.stats()["bytes"] - 1)
    assert cc.stats()["entries"] == 2
    cc.clear()
    assert cc.stats()["entries"] == 0
    assert reg.get("compile_cache_bytes").value() == 0


# ---------------------------------------------------------------------------
# TestRegistryTelemetry
# ---------------------------------------------------------------------------
def test_all_five_families_populate(tmp_path):
    reg = MetricsRegistry()
    cc = CompileCache(str(tmp_path), registry=reg)
    warm(tmp_path, reg, cache=cc)                 # miss
    warm(tmp_path, reg, cache=cc)                 # hit
    snap = reg.snapshot()
    assert snap["compile_cache_hits_total"]["series"][0]["value"] == 1
    assert snap["compile_cache_misses_total"]["series"][0]["value"] == 1
    assert snap["compile_cache_load_ms"]["series"][0]["count"] == 1
    assert snap["compile_cache_compile_ms"]["series"][0]["count"] == 1
    assert snap["compile_cache_bytes"]["series"][0]["value"] \
        == cc.stats()["bytes"] > 0


# ---------------------------------------------------------------------------
# TestConfigValidation
# ---------------------------------------------------------------------------
def _load_cfg(tmp_path, params_lines):
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    cfg = tmp_path / "config.yaml"
    cfg.write_text("model:\n  path: /tmp/nope\nparams:\n"
                   + "".join(f"  {ln}\n" for ln in params_lines))
    return ServingConfig.load(str(cfg), device="cpu")


def test_cache_dir_parses_with_budget(tmp_path):
    cfg = _load_cfg(tmp_path, ["compile_cache_dir: /tmp/zoo-cc",
                               "compile_cache_max_bytes: 512M"])
    assert cfg.compile_cache_dir == "/tmp/zoo-cc"
    assert cfg.compile_cache_max_bytes == 512 << 20


@pytest.mark.parametrize("lines,match", [
    (["compile_cache_dir: {file}"], "not a directory"),
    (["compile_cache_dir: /tmp/zoo-cc", "compile_cache_max_bytes: 0"],
     "positive"),
    (["compile_cache_dir: /tmp/zoo-cc", "compile_cache_max_bytes: -5"],
     "positive"),
    (["compile_cache_max_bytes: 1024"], "compile_cache_dir")])
def test_bad_cache_settings_rejected(tmp_path, lines, match):
    not_a_dir = tmp_path / "somefile"
    not_a_dir.write_text("x")
    with pytest.raises(ValueError, match=match):
        _load_cfg(tmp_path, [ln.format(file=not_a_dir) for ln in lines])


def test_build_model_wires_cache_from_config(tmp_path, monkeypatch):
    """YAML → ServingConfig → build_model: the InferenceModel comes back
    cache-backed and a rebuilt "process" warms from the cache. The
    layer-naming counters start afresh per build, as in a new process."""
    import collections

    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.serving.config import ServingConfig

    def reset_name_scope():
        monkeypatch.setattr(engine, "_name_counters",
                            collections.defaultdict(int))

    reset_name_scope()
    m = TextClassifier(class_num=2, vocab_size=30, embedding_dim=8,
                       sequence_length=6, device="cpu")
    m.model.ensure_built(np.zeros((1, 6), np.int32))
    m.save_model(str(tmp_path / "tc"))
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text(
        f"model:\n  path: {tmp_path / 'tc'}\n"
        f"params:\n  compile_cache_dir: {tmp_path / 'cc'}\n"
        "  compile_cache_max_bytes: 64M\n")
    x = np.arange(3 * 6).reshape(3, 6).astype(np.int32) % 30
    outs = []
    for expect in ("compiled", "cached"):
        reset_name_scope()               # fresh-process naming
        im = ServingConfig.load(str(cfg_file), device="cpu").build_model()
        assert im.compile_cache is not None
        assert im.compile_cache.max_bytes == 64 << 20
        im.warmup(np.zeros((6,), np.int32), buckets=[4])
        assert im.warmup_source["6:b4"] == expect
        outs.append(im.predict(x))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_counter_offset_hits(tmp_path):
    """A rebuild later in the same process shifts every auto layer name
    ("dense_1" → "dense_2"); the canonical key still hits."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as L
    reg = MetricsRegistry()
    cc = CompileCache(str(tmp_path), registry=reg)
    sources, names = [], []
    for _ in range(2):
        m = Sequential([L.Dense(3, input_shape=(4,), device="cpu")])
        m.ensure_built(seed=0)
        names.append(sorted(m.state_dict()))
        im = InferenceModel(device="cpu", compile_cache=cc).load_keras(m)
        im.warmup(np.zeros((4,), np.float32), buckets=[4])
        sources.append(im.warmup_source["4:b4"])
    assert names[0] != names[1], "test premise: auto names must differ"
    assert sources == ["compiled", "cached"]


def test_cache_constructor_validates_too(tmp_path):
    with pytest.raises(ValueError):
        CompileCache(str(tmp_path), max_bytes=0, registry=MetricsRegistry())
    f = tmp_path / "plainfile"
    f.write_text("x")
    with pytest.raises(ValueError):
        CompileCache(str(f), registry=MetricsRegistry())


# ---------------------------------------------------------------------------
# TestTool
# ---------------------------------------------------------------------------
def test_ls_stats_prune_clear(tmp_path, capsys):
    cc = CompileCache(str(tmp_path), registry=MetricsRegistry())
    warm(tmp_path, None, cache=cc, buckets=(1, 2, 4))
    nbytes = cc.stats()["bytes"]

    assert tool.main(["ls", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "3 entries" in out and "serving" in out and "on=cpu" in out

    assert tool.main(["stats", "--dir", str(tmp_path)]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["entries"] == 3 and st["bytes"] == nbytes
    assert st["by_kind"]["serving"]["entries"] == 3

    assert tool.main(["prune", "--dir", str(tmp_path),
                      "--max-bytes", str(nbytes - 1)]) == 0
    capsys.readouterr()
    assert cc.total_bytes() < nbytes

    assert tool.main(["clear", "--dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert cc.total_bytes() == 0


def test_tool_runs_as_a_module(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.compile_cache.tool",
         "stats", "--dir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["entries"] == 0


# ---------------------------------------------------------------------------
# TestConcurrentProcesses
# ---------------------------------------------------------------------------
_WRITER = r"""
import os, sys, time
from analytics_zoo_tpu_torch.compile_cache.key import CacheKey
from analytics_zoo_tpu_torch.compile_cache.store import CompileCache
from analytics_zoo_tpu_torch.observability.registry import MetricsRegistry
cache_dir, go, who = sys.argv[1], sys.argv[2], sys.argv[3]
cc = CompileCache(cache_dir, registry=MetricsRegistry())
open(os.path.join(os.path.dirname(go), "ready-" + who), "w").close()
while not os.path.exists(go):
    time.sleep(0.005)
for rnd in range(20):
    for k in range(3):
        key = CacheKey({"kind": "serving", "bucket": k})
        cc.put(key, (who * 4096 + str(k)).encode())
        assert cc.load(key) is None or True
"""


def test_racing_writers_leave_one_valid_entry_per_key(tmp_path):
    cache_dir, sync = tmp_path / "cc", tmp_path / "sync"
    sync.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER, str(cache_dir), str(sync / "go"),
         who], env=env, cwd=REPO, stderr=subprocess.PIPE, text=True)
        for who in "ab"]
    deadline = time.time() + 60
    while len(os.listdir(sync)) < 2:
        assert time.time() < deadline, "writers never became ready"
        time.sleep(0.01)
    (sync / "go").write_text("")
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    entries = ccstore.scan_dir(str(cache_dir))
    assert len(entries) == 3
    for e in entries:
        header, payload = ccstore.read_entry(
            os.path.join(str(cache_dir), e["file"]))
        assert payload in {(w * 4096 + str(header["bucket"])).encode()
                           for w in "ab"}
    assert not [f for f in os.listdir(cache_dir) if f.startswith(".tmp-")]


def test_reader_survives_concurrent_eviction(tmp_path):
    cache = CompileCache(str(tmp_path), registry=MetricsRegistry())
    im = warm(tmp_path, None, cache=cache, buckets=(1, 2))
    key = im._cache_key(abstract_signature(torch.zeros((1, 3))))
    stop = threading.Event()
    errors = []

    def evictor():
        while not stop.is_set():
            cache.prune(0)
            warm(tmp_path, None, cache=cache, buckets=(1,))

    def reader():
        deadline = time.time() + 1.0
        while time.time() < deadline:
            try:
                cache.load(key)            # hit or None, never raise
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(e)

    t_e, t_r = threading.Thread(target=evictor), threading.Thread(
        target=reader)
    t_e.start()
    t_r.start()
    t_r.join(timeout=30)
    stop.set()
    t_e.join(timeout=30)
    assert not t_r.is_alive() and not t_e.is_alive()
    assert not errors, errors


# ---------------------------------------------------------------------------
# kernel libraries through the store (nvcc and the loader replaced)
# ---------------------------------------------------------------------------
_FAKE_NVCC = r"""#!{python}
import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
with open({runs!r}, "a") as fh:
    fh.write(src + "\n")
with open(out, "wb") as fh:
    fh.write(b"library of " + src.encode())
print("ptxas info    : fake report of " + src)
"""


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    """A fake nvcc (it writes a stand-in library and logs each run), a
    loader that reads the library file, and `_build`'s process state
    reset, with the build directory under `tmp_path`."""
    runs = tmp_path / "nvcc-runs"
    runs.write_text("")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable,
                                      runs=str(runs)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_nvcc_version", "12.4.131")
    loaded = []

    class FakeLib:
        def __init__(self, path):
            self.bytes = open(path, "rb").read()
            loaded.append(path)

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)

    def fresh_process(build_dir):
        """What a new process sees: nothing loaded, an own build dir."""
        monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_compiles", 0)
        monkeypatch.setattr(_build, "_cache_loads", 0)
        monkeypatch.setattr(_build, "_put_checked", set())
        monkeypatch.setattr(_build, "_cache", None)

    def nvcc_runs():
        return [ln for ln in runs.read_text().splitlines() if ln]

    fresh_process(tmp_path / "build1")
    return fresh_process, nvcc_runs


def test_a_library_loads_from_the_store_with_no_nvcc(tmp_path,
                                                     fake_toolchain):
    fresh_process, nvcc_runs = fake_toolchain
    cc = CompileCache(str(tmp_path / "cc"), registry=MetricsRegistry())
    first = _build.load("decode_attention.cu", cache=cc)
    assert len(nvcc_runs()) == 1
    assert _build.build_events() == {"compiles": 1, "cached": 0,
                                     "loaded": 1}
    (entry,) = cc.index()
    header = entry["header"]
    assert header["kind"] == "kernel"
    assert "nvcc 12.4.131" in header["model"]
    assert _build.library_path("decode_attention.cu").name in \
        header["model"]

    fresh_process(tmp_path / "build2")         # a restart, empty build dir
    second = _build.load("decode_attention.cu", cache=cc)
    assert len(nvcc_runs()) == 1, "a warm restart must not run nvcc"
    assert _build.build_events() == {"compiles": 0, "cached": 1,
                                     "loaded": 1}
    assert second.bytes == first.bytes
    assert "fake report" in _build.build_log("decode_attention.cu")


def test_a_flipped_library_byte_rebuilds(tmp_path, fake_toolchain):
    fresh_process, nvcc_runs = fake_toolchain
    cc = CompileCache(str(tmp_path / "cc"), registry=MetricsRegistry())
    _build.load("dropout.cu", cache=cc)
    (entry,) = cc.index()
    _flip_payload_bit(os.path.join(cc.path, entry["file"]))
    fresh_process(tmp_path / "build2")
    lib = _build.load("dropout.cu", cache=cc)
    assert len(nvcc_runs()) == 2
    assert _build.build_events()["compiles"] == 1
    assert lib.bytes.startswith(b"library of ")
    ccstore.read_entry(os.path.join(cc.path, entry["file"]))  # re-put


def test_without_a_cache_the_build_is_as_before(tmp_path, fake_toolchain):
    _, nvcc_runs = fake_toolchain
    _build.load("dropout.cu")
    _build.load("dropout.cu")
    assert len(nvcc_runs()) == 1
    assert _build.build_events() == {"compiles": 1, "cached": 0,
                                     "loaded": 1}


def test_a_library_loaded_before_the_cache_is_put_once_it_is_set(
        tmp_path, fake_toolchain):
    fresh_process, nvcc_runs = fake_toolchain
    _build.load("fused_adam.cu")                # no cache yet
    cc = CompileCache(str(tmp_path / "cc"), registry=MetricsRegistry())
    with _build.library_cache(cc):
        _build.load("fused_adam.cu")
    assert cc.stats()["entries"] == 1
    fresh_process(tmp_path / "build2")
    with _build.library_cache(cc):
        _build.load("fused_adam.cu")
    assert len(nvcc_runs()) == 1
    assert _build.build_events()["cached"] == 1
