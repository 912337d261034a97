"""The port's serving config (`serving/config.py`) and CLI
(`serving/cli.py`). Config cases run on both packages through the `m`
fixture, held to the JAX package's tests/test_cluster_serving_cli.py
(`TestServingConfig`), tests/test_serving_fleet.py (`TestFleetConfig`),
tests/test_rollout.py (`TestRolloutConfig`) and
tests/test_profiling_slo.py (`TestServingConfigSLO`); a model saved by the
JAX package is built by both configs and answers the same. Then the
port's own: the refusals that name the ROADMAP.md item each waits on
(sharded placement and mesh: item 7b; the compile cache: item 1; encrypted
models: item 8), the model classes the text zoo added (Seq2seq and KNRM,
built from a config and served), the device rule, and two
end-to-end runs of ``python -m analytics_zoo_tpu_torch.serving.cli`` as
subprocesses with ``--device cpu`` (a broker and an engine; a gateway and
an engine with heartbeats, SIGTERM exiting 0, and an engine without
``--device`` that finds no GPU and exits non-zero).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from torch_cluster_serving_impls import (  # noqa: F401 (fixtures)
    IMPLS, m, no_stray_threads, wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, text, name="config.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _load(m, tmp_path, text):
    return m.config.ServingConfig.load(_write(tmp_path, text))


def _params(**kv):
    return "model:\n  path: /tmp/nope\nparams:\n" + "".join(
        f"  {k}: {v}\n" for k, v in kv.items())


# ---------------------------------------------------------------------------
# TestServingConfig
# ---------------------------------------------------------------------------
def test_yaml_parse_and_broker_override(m, tmp_path):
    cfg = _load(m, tmp_path, "model:\n  path: /models/ncf\nparams:\n"
                "  core_number: 16\n  concurrent_num: 2\n"
                "redis:\n  host: cacher\n  port: 6380\n")
    assert cfg.model_path == "/models/ncf"
    assert cfg.batch_size == 16 and cfg.concurrent_num == 2
    assert cfg.broker_url == "redis://cacher:6380"
    cfg = _load(m, tmp_path, "model:\n  path: /m\nbroker: tcp://h:7000\n")
    assert cfg.broker_url == "tcp://h:7000" and cfg.batch_size == 32


def test_fallback_parser_three_level_nesting(m):
    parsed = m.config._parse_simple_yaml(
        "model:\n  class: NeuralCF\n  config:\n    user_count: 200\n"
        "    item_count: 100\n  path: /m\nparams:\n  core_number: 4\n"
        "top: 1\n")
    assert parsed == {
        "model": {"class": "NeuralCF",
                  "config": {"user_count": 200, "item_count": 100},
                  "path": "/m"},
        "params": {"core_number": 4}, "top": 1}


@pytest.fixture(scope="module")
def saved_text_classifier(tmp_path_factory):
    """A TextClassifier saved by the JAX package: both configs build it."""
    from analytics_zoo_tpu.models.textclassification import TextClassifier
    tc = TextClassifier(class_num=2, vocab_size=30, embedding_dim=8,
                        sequence_length=6)
    tc.model.ensure_built(np.zeros((1, 6), np.int32))
    path = tmp_path_factory.mktemp("tc") / "tc"
    tc.save_model(str(path))
    return str(path)


def test_build_model_from_zoo_dir(tmp_path, saved_text_classifier):
    rows = np.random.RandomState(0).randint(0, 30, (3, 6)).astype(np.int32)
    outs = {}
    for name, pkg in IMPLS.items():
        cfg = pkg.config.ServingConfig.load(_write(
            tmp_path, f"model:\n  path: {saved_text_classifier}\n"
            "params:\n  device: cpu\n", name=f"{name}.yaml"))
        im = cfg.build_model()
        outs[name] = np.asarray(im.predict(rows))
        assert outs[name].shape == (3, 2)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5,
                               atol=1e-6)


def test_build_model_quantized_from_config(m, tmp_path,
                                           saved_text_classifier):
    cfg = _load(m, tmp_path, f"model:\n  path: {saved_text_classifier}\n"
                "  quantize: int8\nparams:\n  device: cpu\n")
    im = cfg.build_model()
    assert np.asarray(im.predict(np.zeros((3, 6), np.int32))).shape == \
        (3, 2)
    assert im.serving_dtype == "int8"


def test_mesh_block_parses_and_validates(m, tmp_path):
    cfg_mod = m.config
    assert cfg_mod._parse_mesh_axes({"data": 1, "fsdp": 2, "tensor": 4}) \
        == {"data": 1, "fsdp": 2, "tensor": 4}
    assert cfg_mod._parse_mesh_axes("data=1,fsdp=2,tensor=-1") == \
        {"data": 1, "fsdp": 2, "tensor": -1}
    with pytest.raises(ValueError, match="integer"):
        cfg_mod._parse_mesh_axes("tensor=lots")
    with pytest.raises(ValueError, match="placement"):
        _load(m, tmp_path, "model:\n  path: /m\nparams:\n"
              "  mesh: tensor=2\n")


# ---------------------------------------------------------------------------
# TestFleetConfig
# ---------------------------------------------------------------------------
def test_fleet_params_parse(m, tmp_path):
    cfg = _load(m, tmp_path, _params(engine_id="auto",
                                     heartbeat_interval_s=0.5,
                                     engine_ttl_s=2, claim_min_idle_s=4,
                                     claim_interval_s=1))
    assert cfg.engine_id == "auto" and cfg.heartbeat_interval_s == 0.5
    assert cfg.claim_min_idle_s == 4.0
    eid = cfg.resolve_engine_id()
    assert eid and eid.startswith("engine-")
    assert cfg.resolve_engine_id() != eid
    assert _load(m, tmp_path, _params(engine_id="edge-1")
                 ).resolve_engine_id() == "edge-1"
    cfg2 = _load(m, tmp_path, "model:\n  path: /tmp/nope\n")
    assert cfg2.engine_id is None and cfg2.resolve_engine_id() is None


def test_fleet_knobs_rejected(m, tmp_path):
    with pytest.raises(ValueError, match="engine_ttl_s"):
        _load(m, tmp_path, _params(heartbeat_interval_s=5, engine_ttl_s=2))
    with pytest.raises(ValueError, match="claim_interval_s"):
        _load(m, tmp_path, _params(claim_interval_s=0))


def test_partition_params_parse_and_validate(m, tmp_path):
    cfg = _load(m, tmp_path, _params(pipelined="true", partitions=4,
                                     partition_lease_ttl_s=2))
    assert cfg.partitions == 4 and not cfg.reshard
    assert cfg.partition_lease_ttl_s == 2.0
    with pytest.raises(ValueError, match="params.partitions"):
        _load(m, tmp_path, _params(pipelined="true", partitions=0))
    with pytest.raises(ValueError, match="pipelined"):
        _load(m, tmp_path, _params(pipelined="false", partitions=2))


def test_cli_validation_exits(m, tmp_path):
    with pytest.raises(SystemExit, match="engine-ttl"):
        m.cli.main(["gateway", "--engine-ttl", "0"])
    with pytest.raises(SystemExit, match="partitions"):
        m.cli.main(["gateway", "--partitions", "0"])
    path = _write(tmp_path, _params(pipelined="true", partitions=2))
    with pytest.raises(SystemExit, match="engine-id"):
        m.cli.main(["start", "--config", path])


# ---------------------------------------------------------------------------
# TestRolloutConfig, TestServingConfigSLO
# ---------------------------------------------------------------------------
def _rollout(m, tmp_path, lines):
    return _load(m, tmp_path, "model:\n  path: /tmp/model\nparams:\n"
                 "  engine_id: e1\n  rollout:\n"
                 + "".join(f"    {line}\n" for line in lines))


def test_rollout_params_parse_and_defaults(m, tmp_path):
    cfg = _rollout(m, tmp_path, ["model_dir: /ckpts", "poll_interval_s: 1.5",
                                 "golden_tolerance: 0.25",
                                 "engine_timeout_s: 90"])
    assert cfg.rollout_model_dir == "/ckpts"
    assert cfg.rollout_poll_interval_s == 1.5
    assert cfg.rollout_golden_tolerance == 0.25
    assert cfg.rollout_engine_timeout_s == 90.0
    cfg = _load(m, tmp_path, "model:\n  path: /tmp/m\n")
    assert cfg.rollout_model_dir is None
    assert cfg.rollout_poll_interval_s == 2.0


@pytest.mark.parametrize("lines,match", [
    (["model_dir: /x", "poll_interval_s: 0"], "poll_interval_s"),
    (["model_dir: /x", "drain_timeout_s: -1"], "drain_timeout_s"),
    (["model_dir: /x", "golden_tolerance: -0.1"], "golden_tolerance"),
    (["model_dir: /x", "engine_timeout_s: 0"], "engine_timeout_s")])
def test_bad_rollout_knobs_fail_at_load(m, tmp_path, lines, match):
    with pytest.raises(ValueError, match=match):
        _rollout(m, tmp_path, lines)


def test_slo_block_and_profile_knobs(m, tmp_path):
    cfg = _load(m, tmp_path, "model:\n  path: /tmp/nowhere\nparams:\n"
                "  slo:\n    latency_ms: 50\n    latency_quantile: 0.9\n"
                "    availability: 0.999\n    window_s: 120\n"
                "  profile_dir: /tmp/profiles\n  profile_max_artifacts: 3\n")
    obj = cfg.build_slo()
    assert (obj.latency_ms, obj.latency_quantile, obj.availability,
            obj.window_s) == (50.0, 0.9, 0.999, 120.0)
    assert cfg.profile_dir == "/tmp/profiles"
    assert cfg.profile_max_artifacts == 3
    assert _load(m, tmp_path, "model:\n  path: /tmp/nowhere\n"
                 ).build_slo() is None
    with pytest.raises(ValueError, match="availability"):
        _load(m, tmp_path, "model:\n  path: /tmp/nowhere\nparams:\n"
              "  slo:\n    availability: 2.0\n")
    with pytest.raises(ValueError, match="profile_max_artifacts"):
        _load(m, tmp_path, _params(profile_max_artifacts=0))


# ---------------------------------------------------------------------------
# the port's own refusals and device rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("body,match", [
    ("params:\n  placement: sharded\n", "item 7"),
    ("params:\n  placement: sharded\n  mesh: data=1,fsdp=2\n", "item 7"),
    ("secure:\n  model_encrypted: true\n", "item 8")])
def test_port_refusals_name_their_item(tmp_path, body, match):
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    with pytest.raises(NotImplementedError, match=match):
        ServingConfig.load(_write(tmp_path, "model:\n  path: /m\n" + body))


def test_port_accepts_compile_cache_dir(tmp_path):
    from analytics_zoo_tpu_torch.compile_cache import CompileCache
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    cc = tmp_path / "cc"
    cfg = ServingConfig.load(_write(
        tmp_path, "model:\n  path: /m\nparams:\n"
        f"  compile_cache_dir: {cc}\n  compile_cache_max_bytes: 64M\n"))
    cache = cfg.build_compile_cache()
    assert isinstance(cache, CompileCache)
    assert cache.path == str(cc) and cache.max_bytes == 64 << 20


def test_port_refuses_jax_only_classes_and_unknown_names(tmp_path):
    """`Seq2seq` and `KNRM` were refused here until the text zoo was
    ported; now each is built from a config (its saved ZooModel
    directory) and serves a request on the CPU as its own forward does.
    An unknown name is still refused."""
    from analytics_zoo_tpu_torch.models import seq2seq, textmatching
    from analytics_zoo_tpu_torch.serving.config import (ServingConfig,
                                                        _find_model_class)
    assert _find_model_class("Seq2seq") is seq2seq.Seq2seq
    assert _find_model_class("KNRM") is textmatching.KNRM
    with pytest.raises(ValueError, match="Unknown model class"):
        _find_model_class("NoSuchModel")
    assert _find_model_class("BERTClassifier").__module__ == \
        "analytics_zoo_tpu_torch.models.bert"
    rs = np.random.RandomState(2)
    s2s = seq2seq.Seq2seq(encoder_hidden=[4], decoder_hidden=[3],
                          bridge="dense", generator_units=2, device="cpu")
    s2s_x = [rs.randn(2, 5, 3).astype(np.float32),
             rs.randn(2, 4, 2).astype(np.float32)]
    knrm = textmatching.KNRM(3, 4, vocab_size=20, embed_size=6,
                             kernel_num=4, device="cpu")
    knrm_x = rs.randint(1, 20, (2, 7)).astype(np.int32)
    for model, x in ((s2s, s2s_x), (knrm, knrm_x)):
        model.model.ensure_built(x, seed=1)
        path = tmp_path / type(model).__name__
        model.save_model(str(path))
        cfg = ServingConfig.load(_write(
            tmp_path, f"model:\n  path: {path}\nparams:\n  device: cpu\n"))
        im = cfg.build_model()
        np.testing.assert_allclose(im.predict(x), model.predict(x),
                                   rtol=0, atol=1e-6)


def test_port_device_defaults_to_cuda(tmp_path, saved_text_classifier):
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    cfg = ServingConfig.load(_write(
        tmp_path, f"model:\n  path: {saved_text_classifier}\n"))
    assert cfg.device == "cuda"
    assert ServingConfig.load(_write(
        tmp_path, "model:\n  path: /m\n"), device="cpu").device == "cpu"
    with pytest.raises(ValueError, match="params.device"):
        ServingConfig.load(_write(tmp_path, _params(device="tpu")))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build_model()


def test_port_serves_a_keras_net_by_class(tmp_path):
    """`model.class` naming a Keras-style net (the BERT task models): its
    constructor arguments under `model.config`, its artifact at
    `<path>/weights`."""
    from analytics_zoo_tpu_torch.models.bert import BERTClassifier
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    kw = dict(vocab=20, hidden_size=16, n_block=1, n_head=2, seq_len=4,
              intermediate_size=32)
    net = BERTClassifier(2, device="cpu", **kw)
    net.ensure_built(seed=3)
    net.save_weights(str(tmp_path / "weights"))
    conf = "".join(f"    {k}: {v}\n" for k, v in kw.items())
    cfg = ServingConfig.load(_write(
        tmp_path, f"model:\n  class: BERTClassifier\n  path: {tmp_path}\n"
        f"  config:\n    num_classes: 2\n{conf}params:\n  device: cpu\n"))
    im = cfg.build_model()
    ids = np.random.RandomState(1).randint(0, 20, (3, 4)).astype(np.int64)
    want = np.asarray(net.predict(ids))
    np.testing.assert_allclose(im.predict(ids), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI end to end, as subprocesses (--device cpu)
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.cli", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


class _Lines:
    """Collects a child's output lines on a daemon thread."""

    def __init__(self, proc):
        self.lines = []
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def find(self, prefix):
        return next((ln for ln in self.lines if ln.startswith(prefix)), None)


def _stop(procs, timeout=30):
    codes = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
            codes.append(None)
    return codes


def test_cli_broker_and_start_roundtrip(tmp_path, saved_text_classifier):
    from analytics_zoo_tpu_torch.serving.client import InputQueue
    port = _free_port()
    broker = _spawn("broker", "--host", "127.0.0.1", "--port", str(port))
    cfg = _write(tmp_path, f"model:\n  path: {saved_text_classifier}\n"
                 f"broker: tcp://127.0.0.1:{port}\n")
    serving = _spawn("start", "--config", cfg, "--device", "cpu")
    out = _Lines(serving)
    try:
        q = InputQueue(f"tcp://127.0.0.1:{port}")
        deadline = time.monotonic() + 120
        got = None
        while got is None and time.monotonic() < deadline:
            try:
                got = q.predict(np.zeros((6,), np.int64), timeout_s=10)
            except (ConnectionRefusedError, TimeoutError, OSError):
                time.sleep(0.5)
        assert got is not None and np.asarray(got).shape == (2,)
        assert out.find("placement=replicated") is not None
        assert "device=cpu" in out.find("placement=replicated")
    finally:
        codes = _stop([serving, broker])
    assert codes == [0, 0], out.lines[-20:]
    counts = [json.loads(ln) for ln in out.lines
              if ln.startswith('{"kernel_counts"')]
    assert [c["kernel_counts"] for c in counts] == ["started", "stopped"]


def test_cli_gateway_tracks_a_cli_engine(tmp_path, saved_text_classifier):
    """A gateway and an engine as two `cli` processes: the engine's
    heartbeats make the gateway's /healthz 200, /predict answers through
    the gateway, SIGTERM stops both with exit 0 and the engine's row goes.
    An engine left on the default device finds no GPU here and exits
    non-zero, naming device='cpu'."""
    from analytics_zoo_tpu_torch.serving.broker import RedisBroker
    from analytics_zoo_tpu_torch.serving.fleet import engines_key
    from analytics_zoo_tpu_torch.serving.redis_server import MiniRedisServer
    srv = MiniRedisServer().start()
    cfg = _write(tmp_path, f"model:\n  path: {saved_text_classifier}\n"
                 f"broker: {srv.url}\nparams:\n  heartbeat_interval_s: 0.5\n"
                 "  engine_ttl_s: 20\n  fleet_metrics_interval_s: 0.5\n")
    gateway = _spawn("gateway", "--broker", srv.url, "--host", "127.0.0.1",
                     "--port", "0", "--engine-ttl", "20")
    engine = _spawn("start", "--config", cfg, "--device", "cpu",
                    "--engine-id", "auto")
    nogpu = None if torch.cuda.is_available() else _spawn(
        "start", "--config", cfg, "--engine-id", "auto")
    gw_out, eng_out = _Lines(gateway), _Lines(engine)
    try:
        wait_for(lambda: gw_out.find("fleet gateway on :") is not None,
                 timeout_s=120, interval=0.1, msg="gateway port")
        base = "http://127.0.0.1:" + gw_out.find(
            "fleet gateway on :").split(":")[1].split()[0]

        def healthy():
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    return json.loads(r.read())["fleet"]["ready"] == 1
            except urllib.error.HTTPError:
                return False
        wait_for(healthy, timeout_s=120, interval=0.2, msg="engine alive")
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"instances": [[1, 2, 3, 4, 5, 6]]}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert np.asarray(json.loads(r.read())["predictions"]).shape \
                == (1, 2)
        if nogpu is not None:
            out, _ = nogpu.communicate(timeout=120)
            assert nogpu.returncode != 0 and "device='cpu'" in out
    finally:
        codes = _stop([engine, gateway] + ([nogpu] if nogpu else []))
        client = RedisBroker(srv.host, srv.port)
        rows = client.hgetall(engines_key("serving_stream"))
        client.close()
        srv.stop()
    assert codes[:2] == [0, 0], (gw_out.lines[-10:], eng_out.lines[-10:])
    assert eng_out.find("cluster serving started") is not None
    assert rows == {}          # a clean stop deregisters the engine
