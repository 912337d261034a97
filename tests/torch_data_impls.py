"""Shared helpers of the data-layer port tests (`test_torch_data_*.py`).

`run_jax_case` runs one test method of a JAX package test module (for
example `test_tfrecord.TestFraming.test_write_read_round_trip`) with the
module's globals rebound to the port's modules, so the reference's own
cases hold the port's copy. `with_timeout` runs a threaded case under a
deadline of its own: a pipeline that hangs fails the test instead of the
run. `no_pipeline_threads` lists the data layer's threads still alive.
"""

import inspect
import threading
import time


def with_timeout(fn, seconds: float = 30.0):
    """`fn()` on a daemon thread; its exception re-raised here, or a
    TimeoutError after `seconds`."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True, name="case-under-timeout")
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise TimeoutError(f"case still running after {seconds} s")
    if err:
        raise err[0]
    return out[0] if out else None


def run_jax_case(module, case: str, patches, monkeypatch, tmp_path,
                 seconds: float = 30.0):
    """Run `module`'s `Class.method` (or a module-level `test_fn`) with
    `patches` ({global name: port object}) applied to the module."""
    for name, value in patches.items():
        monkeypatch.setattr(module, name, value)
    if "." in case:
        cls, meth = case.split(".")
        fn = getattr(getattr(module, cls)(), meth)
    else:
        fn = getattr(module, case)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    kwargs = {k: given[k] for k in inspect.signature(fn).parameters}
    return with_timeout(lambda: fn(**kwargs), seconds)


PIPELINE_THREADS = ("input-pipeline-", "train-prefetch")


def no_pipeline_threads(wait_s: float = 5.0):
    """The pipeline and prefetch threads still alive after `wait_s`."""
    deadline = time.monotonic() + wait_s
    while True:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(PIPELINE_THREADS)]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)
