"""The port's TFRecord codec (`analytics_zoo_tpu_torch/data/tfrecord.py`,
`onnx/wire.py`, `data/native_loader.py`'s build) held against the JAX
package's: files written by either package read back identically in the
other, encoded Examples are byte-equal, the native and the Python scans
agree and a corrupt record's error names the file and the offset as in
JAX. Inputs come from numpy seeds; every comparison is exact. A few cases
of `tests/test_tfrecord.py` run against the port's copy."""

import os

import numpy as np
import pytest
import test_tfrecord as jt
from torch_data_impls import run_jax_case

from analytics_zoo_tpu.data import tfrecord as jtfr
from analytics_zoo_tpu.onnx import wire as jwire
from analytics_zoo_tpu_torch.data import dataset as tdataset
from analytics_zoo_tpu_torch.data import native_loader as tnl
from analytics_zoo_tpu_torch.data import tfrecord as ttfr
from analytics_zoo_tpu_torch.kernels import _build
from analytics_zoo_tpu_torch.onnx import wire as twire

PKGS = {"jax": jtfr, "torch": ttfr}


def _examples(seed, n=12):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "image/encoded": rs.bytes(rs.randint(1, 200)),
            "image/class/label": np.asarray([rs.randint(1000)], np.int64),
            "neg": rs.randint(-2 ** 40, 2 ** 40, 3).astype(np.int64),
            "w": rs.randn(rs.randint(1, 5)).astype(np.float32),
            "words": ["a", "bc"][: 1 + i % 2],
            "name": f"rec_{i}"})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_encoded_examples_byte_equal(seed):
    for ex in _examples(seed):
        a, b = jtfr.encode_example(ex), ttfr.encode_example(ex)
        assert a == b
        ja, tb = jtfr.decode_example(a), ttfr.decode_example(a)
        assert ja.keys() == tb.keys()
        for k in ja:
            if isinstance(ja[k], list):
                assert ja[k] == tb[k]
            else:
                assert ja[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(ja[k], tb[k])


def test_wire_codec_is_the_jax_copy():
    schema = {1: ("name", "string"), 2: ("v", "varint"),
              3: ("f", "float"), 4: ("sub", ("msg", {1: ("b", "bytes")}))}
    msg = {"name": ["x"], "v": [1, 2 ** 40], "f": [0.5],
           "sub": [{"b": [b"\x00\xff"]}]}
    blob = twire.encode(msg, schema)
    assert blob == jwire.encode(msg, schema)
    assert twire.decode(blob, schema) == jwire.decode(blob, schema)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_read_back_identically_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "f.tfrecord")
    payloads = [ttfr.encode_example(ex) for ex in _examples(2)]
    assert PKGS[writer].write_tfrecord(path, payloads) == len(payloads)
    reader = PKGS["torch" if writer == "jax" else "jax"]
    got = list(reader.read_records(path, verify_payload=True))
    assert got == payloads == list(
        PKGS[writer].read_records(path, verify_payload=True))
    assert reader.count_records(path) == len(payloads)
    for a, b in zip(jtfr.scan_index(path), ttfr.scan_index(path)):
        np.testing.assert_array_equal(a, b)
    jb, tb = jtfr.decode_example_batch(got), ttfr.decode_example_batch(got)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], list):
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("route", ["native", "python"])
def test_written_files_byte_equal_jax(route, tmp_path, monkeypatch):
    """The port's writer takes long payloads' CRCs from the native
    scanner (`_payload_crc`) where it is built: the same bytes as the
    JAX writer's Python CRC, on either route."""
    rs = np.random.RandomState(9)
    recs = [rs.bytes(n) for n in (0, 1, 255, 256, 257, 4096, 70000)]
    if route == "python":
        _python_walk(monkeypatch)
    else:
        assert ttfr._native_lib() is not None
    ttfr.write_tfrecord(str(tmp_path / "t"), recs)
    jtfr.write_tfrecord(str(tmp_path / "j"), recs)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for r in recs:
        assert ttfr._payload_crc(r) == jtfr.masked_crc32c(r)


def _python_walk(monkeypatch):
    """Force the port's Python frame walk."""
    monkeypatch.setattr(ttfr, "_native", None)
    monkeypatch.setattr(ttfr, "_native_failed", True)


def test_native_scanner_built_into_the_port_build_dir():
    lib = ttfr._native_lib()
    assert lib is not None, "g++ builds native/tfrecord_scanner.cpp here"
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.realpath(str(_build.BUILD_DIR)))
    src, out = tnl.native_paths("tfrecord_scanner")
    assert os.path.basename(src) == "tfrecord_scanner.cpp"
    assert os.path.dirname(os.path.realpath(src)).endswith("native")
    assert os.path.realpath(out) == path


def test_native_and_python_scans_agree(tmp_path, monkeypatch):
    path = str(tmp_path / "p.tfrecord")
    rs = np.random.RandomState(3)
    records = [rs.bytes(rs.randint(1, 300)) for _ in range(40)]
    ttfr.write_tfrecord(path, records)
    assert ttfr._native_lib() is not None
    native = (list(ttfr.read_records(path, verify_payload=True)),
              ttfr.scan_index(path, verify_payload=True),
              ttfr.count_records(path))
    _python_walk(monkeypatch)
    python = (list(ttfr.read_records(path, verify_payload=True)),
              ttfr.scan_index(path, verify_payload=True),
              ttfr.count_records(path))
    assert native[0] == python[0] == records
    for a, b in zip(native[1], python[1]):
        np.testing.assert_array_equal(a, b)
    assert native[2] == python[2] == 40


@pytest.mark.parametrize("damage", ["length_crc", "payload_crc", "torn"])
@pytest.mark.parametrize("route", ["native", "python"])
def test_corrupt_record_error_names_file_and_offset(damage, route,
                                                    tmp_path, monkeypatch):
    path = str(tmp_path / "bad.tfrecord")
    recs = [b"a" * 10, b"b" * 20, b"c" * 30]
    ttfr.write_tfrecord(path, recs)
    blob = bytearray(open(path, "rb").read())
    second = 12 + 10 + 4                       # the second frame's offset
    if damage == "length_crc":
        blob[second + 2] ^= 0xFF
    elif damage == "payload_crc":
        blob[second + 12] ^= 0xFF
    else:
        blob = blob[:second + 12 + 5]
    open(path, "wb").write(bytes(blob))
    if route == "python":
        _python_walk(monkeypatch)
    with pytest.raises(ValueError) as got:
        list(ttfr.read_records(path, verify_payload=True))
    with pytest.raises(ValueError) as want:
        list(jtfr.read_records(path, verify_payload=True))
    assert str(got.value) == str(want.value)
    assert path in str(got.value) and f"offset {second}" in str(got.value)


def test_zoo_disable_native_is_respected(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_DISABLE_NATIVE", "1")
    monkeypatch.setattr(ttfr, "_native", None)
    monkeypatch.setattr(ttfr, "_native_failed", False)
    assert ttfr._native_lib() is None
    path = str(tmp_path / "d.tfrecord")
    ttfr.write_tfrecord(path, [b"abc"])
    assert list(ttfr.read_records(path)) == [b"abc"]


def test_iter_examples_matches_jax(tmp_path):
    for s in range(2):
        ttfr.write_tfrecord(str(tmp_path / f"p-{s}"), [
            ttfr.encode_example(ex) for ex in _examples(10 + s, 5)])
    pattern = str(tmp_path / "p-*")
    parse = lambda ex: (ex["w"].sum(), ex["name"])  # noqa: E731
    assert list(ttfr.iter_examples(pattern, parse)) == \
        list(jtfr.iter_examples(pattern, parse))


JAX_CASES = [
    "TestCRC.test_crc32c_known_vector",
    "TestExampleCodec.test_round_trip_all_kinds",
    "TestExampleCodec.test_int_scalar_and_float64_coerce",
    "TestFraming.test_write_read_round_trip",
    "TestFraming.test_corrupt_header_detected",
    "TestFraming.test_corrupt_payload_detected_only_when_verifying",
    "TestFraming.test_truncated_file",
    "TestFraming.test_truncated_inside_crc_field_is_valueerror",
    "TestFraming.test_empty_corpus_clear_errors",
    "TestTFRecordDataset.test_streaming_batches_cover_corpus",
    "TestTFRecordDataset.test_no_shuffle_preserves_order",
    "TestTFRecordDataset.test_shuffle_seed_deterministic",
    "TestTFRecordDataset.test_parse_fn_required",
    "TestTFRecordDataset.test_explicit_list_with_typo_raises",
    "TestTFRecordDataset.test_count_records_rejects_garbage",
    "TestTFRecordDataset.test_first_sample_and_materialize",
]


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_tfrecord_cases_on_the_port(case, monkeypatch, tmp_path):
    run_jax_case(jt, case, {"tfr": ttfr,
                            "TPUDataset": tdataset.TPUDataset},
                 monkeypatch, tmp_path)
