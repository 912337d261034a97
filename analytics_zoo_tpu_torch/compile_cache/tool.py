"""Maintenance CLI for a persistent compile cache directory.

Port of `scripts/compile_cache_tool.py` (L1-155). It reuses the cache
package's entry/index format (`compile_cache/store.py` — the directory IS
the index; every entry file is self-describing), so it works on any cache
dir without the serving process running:

    python -m analytics_zoo_tpu_torch.compile_cache.tool ls    --dir DIR
    python -m analytics_zoo_tpu_torch.compile_cache.tool stats --dir DIR
    python -m analytics_zoo_tpu_torch.compile_cache.tool prune --dir DIR \\
        --max-bytes 512M
    python -m analytics_zoo_tpu_torch.compile_cache.tool clear --dir DIR

`ls` prints one line per entry (oldest-touched first — the LRU eviction
order) with the key anatomy from the header: kind ("serving" for a
capture record, "kernel" for a kernel library), placement, input shape /
dtype, the torch version and the card. `prune` applies the same LRU
policy the serving process enforces under `compile_cache_max_bytes`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from analytics_zoo_tpu_torch.compile_cache.store import (dir_bytes,
                                                         prune_dir, scan_dir)
from analytics_zoo_tpu_torch.serving.config import _parse_bytes


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _age(ts) -> str:
    if not ts:
        return "?"
    s = max(0, time.time() - float(ts))
    for div, unit in ((86400, "d"), (3600, "h"), (60, "m")):
        if s >= div:
            return f"{s / div:.1f}{unit}"
    return f"{s:.0f}s"


def _entry_line(e) -> str:
    if "corrupt" in e:
        return (f"{e['digest'][:12]}  {_fmt_bytes(e['bytes']):>9}  "
                f"CORRUPT: {e['corrupt']}")
    h = e.get("header", {})
    sig = h.get("signature") or {}
    leaves = sig.get("leaves") or []
    # the batch input is the last leaf; a kernel library names its source
    shapes = ",".join(
        "x".join(map(str, shape)) + f":{dtype}"
        for shape, dtype in leaves[-1:]) or str(sig.get("tree", "?"))
    return (f"{e['digest'][:12]}  {_fmt_bytes(e['bytes']):>9}  "
            f"used {_age(e['last_used']):>6} ago  "
            f"{h.get('kind', '?'):>7}  {h.get('placement', '?'):>10}  "
            f"in={shapes}  torch={h.get('torch', '?')}  "
            f"on={h.get('device_kind', '?')}")


def cmd_ls(args) -> int:
    entries = scan_dir(args.dir)
    if args.json:
        print(json.dumps(entries, default=str))
        return 0
    if not entries:
        print(f"(no cache entries in {args.dir})")
        return 0
    for e in entries:
        print(_entry_line(e))
    print(f"{len(entries)} entries, {_fmt_bytes(dir_bytes(args.dir))}")
    return 0


def cmd_stats(args) -> int:
    entries = scan_dir(args.dir)
    by_kind = {}
    for e in entries:
        k = e.get("header", {}).get("kind", "corrupt"
                                    if "corrupt" in e else "?")
        by_kind.setdefault(k, [0, 0])
        by_kind[k][0] += 1
        by_kind[k][1] += e["bytes"]
    print(json.dumps({
        "path": os.path.abspath(args.dir),
        "entries": len(entries),
        "bytes": sum(e["bytes"] for e in entries),
        "corrupt": sum(1 for e in entries if "corrupt" in e),
        "by_kind": {k: {"entries": n, "bytes": b}
                    for k, (n, b) in sorted(by_kind.items())},
        "oldest_used": min((e["last_used"] for e in entries),
                           default=None),
        "newest_used": max((e["last_used"] for e in entries),
                           default=None),
    }))
    return 0


def cmd_prune(args) -> int:
    try:
        budget = _parse_bytes(args.max_bytes)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if budget <= 0:
        raise SystemExit(f"--max-bytes {args.max_bytes!r} must be positive")
    removed, freed = prune_dir(args.dir, budget)
    print(f"pruned {removed} entr{'y' if removed == 1 else 'ies'} "
          f"({_fmt_bytes(freed)}); {_fmt_bytes(dir_bytes(args.dir))} "
          f"remain under the {_fmt_bytes(budget)} budget")
    return 0


def cmd_clear(args) -> int:
    removed, freed = prune_dir(args.dir, -1)
    print(f"cleared {removed} entr{'y' if removed == 1 else 'ies'} "
          f"({_fmt_bytes(freed)})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="compile-cache-tool", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, hlp in (("ls", cmd_ls, "list entries, LRU order"),
                          ("stats", cmd_stats, "aggregate stats as JSON"),
                          ("prune", cmd_prune,
                           "evict LRU entries past a byte budget"),
                          ("clear", cmd_clear, "remove every entry")):
        sp = sub.add_parser(name, help=hlp)
        sp.add_argument("--dir", required=True,
                        help="cache directory (compile_cache_dir)")
        if name == "ls":
            sp.add_argument("--json", action="store_true",
                            help="machine-readable index dump")
        if name == "prune":
            sp.add_argument("--max-bytes", required=True,
                            help='byte budget, e.g. 1048576 or "512M"')
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    if not os.path.isdir(args.dir):
        raise SystemExit(f"{args.dir!r} is not a directory")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
