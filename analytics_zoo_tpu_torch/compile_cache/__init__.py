"""Persistent compile cache for serving and training.

Port of `analytics_zoo_tpu/compile_cache/` (`__init__.py`, `key.py`,
`store.py`, `aot_fn.py`, `serialization.py`) and
`scripts/compile_cache_tool.py`. The JAX package persists whole AOT
executables so a restart compiles nothing. The port's counterpart of a
jitted, cached executable is a CUDA graph captured at warmup and replayed,
and a graph cannot be written to disk. So the persistent half holds the
rest of what a warm restart would otherwise rebuild:

- the kernel libraries nvcc built (`kernels/_build.py` puts each `.so` and
  its ptxas log as an entry, keyed on the source hash, the nvcc version
  and the card);
- a capture record per warmed program, a marker (the program's name)
  keyed as the JAX package keys the executable.

A warm restart fetches the libraries, runs no nvcc, captures its graphs
anew (milliseconds a bucket) and reports each bucket "cached".

- `CompileCache` (`store.py`) — the disk store: CRC-checked entries,
  atomic write-then-rename, LRU eviction under a byte budget, and hit /
  miss / load / compile telemetry in the registry. A corrupt, truncated
  or format-mismatched entry is a miss, never an exception.
- `make_key` / fingerprints (`key.py`) — the key anatomy: torch and CUDA
  runtime versions, the card's name and compute capability, model fn +
  params structure, input signature (bucket shape + dtype), placement,
  dtype.
- `GraphProgram` / `ProgramTable` / `capture_program` (`graphs.py`) — the
  programs themselves: captured on the card, the same static-buffer
  protocol run eagerly on the CPU; `TrainProgram`, a fit's program of one
  or more training steps (`learn/trainer.py` writes its capture records
  under `compile_cache_dir`), and `eager_programs()`, which runs them
  eagerly for a check.
- `tool.py` — `python -m analytics_zoo_tpu_torch.compile_cache.tool
  ls|stats|prune|clear --dir DIR`.
"""

from analytics_zoo_tpu_torch.compile_cache.graphs import (CaptureError,
                                                          GraphProgram,
                                                          ProgramTable,
                                                          TrainProgram,
                                                          capture_program,
                                                          eager_programs)
from analytics_zoo_tpu_torch.compile_cache.key import (CacheKey,
                                                       abstract_signature,
                                                       cheap_signature,
                                                       fingerprint, make_key,
                                                       model_fingerprint,
                                                       structure_signature)
from analytics_zoo_tpu_torch.compile_cache.store import (CompileCache,
                                                         get_cache)

__all__ = [
    "CacheKey", "CaptureError", "CompileCache", "GraphProgram",
    "ProgramTable", "TrainProgram", "abstract_signature",
    "capture_program", "eager_programs",
    "cheap_signature", "fingerprint", "get_cache", "make_key",
    "model_fingerprint", "structure_signature",
]
