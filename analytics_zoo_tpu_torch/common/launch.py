"""`zoo-launch` — one-call multi-host training launcher.

Port of `analytics_zoo_tpu/common/launch.py` (L1-225): `detect_hosts`,
`build_commands` (L61), `launch` (L126) and `main` (L184), with the same
env contract: every process runs the same script with
`COORDINATOR_ADDRESS`, `ZOO_NUM_PROCESSES` and `ZOO_PROCESS_ID` (read by
`ZooConfig.from_env` inside `init_orca_context(cluster_mode="multi-host")`)
and `PYTHONPATH`; the port adds `ZOO_LOCAL_PROCESSES` (the ranks per
host, which pick each rank's card). One process is one rank, so
`--simulate-devices N` is a rank count: N ranks per host on the CPU
(`ZOO_DEVICE=cpu`, gloo) in place of `--nproc`, with no bootstrap runner
(the JAX package's `--bootstrap-devices` forces virtual CPU devices into
jax before the script runs). A launch whose hosts are all local and that
names no coordinator or port rendezvouses through a `FileStore` in a
fresh temporary directory (removed when the group's wait returns), so
concurrent launches on one machine cannot race for a port.

Reference role: the one-call cluster bootstraps (`init_spark_on_yarn` /
`init_spark_standalone`, `pyzoo/zoo/common/nncontext.py:56,129,199`;
`scripts/standalone/start-standalone.sh`) that turn "a list of hosts"
into a running distributed job. Every process runs the SAME script; the
launcher's whole job is to assign coordinator/world env and to supervise
the process group fail-fast like `launch_local_cluster` does
(`common/cluster.py ProcessMonitor`).

    # 2 hosts x 4 processes, rendezvous on hostA:29400
    zoo-launch --hosts hostA,hostB --nproc 4 train.py --epochs 3

    # local simulation: 2 CPU ranks on this machine
    zoo-launch --simulate-devices 2 train.py

Remote processes start through `--ssh-cmd` (default `ssh`); anything
argv-shaped works (`--ssh-cmd "kubectl exec -i"` for GKE pods, a bash
shim in tests). Local hosts (`localhost`/`127.0.0.1`) spawn directly.
"""

from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common.cluster import (ProcessMonitor,
                                                    rendezvous_dir)

_LOCAL_HOSTS = {"localhost", "127.0.0.1", "::1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _is_local(host: str) -> bool:
    return host.split("@")[-1] in _LOCAL_HOSTS


def detect_hosts() -> List[str]:
    """Pod-slice autodetect: the platform publishes the worker list
    (`TPU_WORKER_HOSTNAMES`, comma-separated). Fallback: this host."""
    names = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    hosts = [h.strip() for h in names.split(",") if h.strip()]
    return hosts or ["localhost"]


def build_commands(hosts: Sequence[str], nproc: int, coordinator: str,
                   script: str, script_args: Sequence[str],
                   python: str = sys.executable, ssh_cmd: str = "ssh",
                   extra_env: Optional[Dict[str, str]] = None,
                   simulate_devices: int = 0
                   ) -> List[Tuple[List[str], Optional[Dict[str, str]]]]:
    """One (argv, env) pair per process, ranks assigned host-major so
    rank r lives on host r // nproc. env is None for ssh'd commands (env
    rides inside the remote command line). `simulate_devices` N > 0 runs
    N CPU ranks per host in place of `nproc`."""
    if simulate_devices:
        nproc = int(simulate_devices)
    world = len(hosts) * nproc
    out: List[Tuple[List[str], Optional[Dict[str, str]]]] = []
    # the launch cwd is importable on every worker (`python script.py`
    # only puts the SCRIPT's dir on sys.path) — the spark-submit
    # ships-the-project role
    pythonpath = os.pathsep.join(
        p for p in (os.getcwd(), os.environ.get("PYTHONPATH")) if p)
    rank = 0
    for host in hosts:
        for _ in range(nproc):
            env_vars = {
                "COORDINATOR_ADDRESS": coordinator,
                "ZOO_NUM_PROCESSES": str(world),
                "ZOO_PROCESS_ID": str(rank),
                "ZOO_LOCAL_PROCESSES": str(nproc),
                "PYTHONPATH": pythonpath,
                **(extra_env or {}),
            }
            if simulate_devices:
                env_vars["ZOO_DEVICE"] = "cpu"
            if _is_local(host):
                env = dict(os.environ)
                env.update(env_vars)
                out.append(([python, script, *script_args], env))
            else:
                assignments = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in env_vars.items())
                remote = (f"cd {shlex.quote(os.getcwd())} && "
                          f"env {assignments} {shlex.quote(python)} "
                          f"{shlex.quote(script)} "
                          + " ".join(shlex.quote(a) for a in script_args))
                # "{host}" placeholder lets exec styles that need args
                # AFTER the target work (kubectl >=1.22 requires
                # `exec POD -- cmd`): --ssh-cmd "kubectl exec -i {host} --"
                parts = shlex.split(ssh_cmd)
                if any("{host}" in p for p in parts):
                    argv = [p.replace("{host}", host) for p in parts]
                else:
                    argv = [*parts, host]
                out.append(([*argv, remote], None))
            rank += 1
    return out


def launch(hosts: Sequence[str], nproc: int, script: str,
           script_args: Sequence[str] = (),
           coordinator: Optional[str] = None, port: Optional[int] = None,
           python: str = sys.executable, ssh_cmd: str = "ssh",
           simulate_devices: int = 0,
           extra_env: Optional[Dict[str, str]] = None) -> ProcessMonitor:
    """Start the full host×nproc process group and return its monitor
    (fail-fast `.wait()`, group `.terminate()`).

    All-local hosts with no coordinator and no port rendezvous through a
    fresh `FileStore`. A local launch given a port uses 127.0.0.1:port.
    Remote coordinators default to a port DERIVED from the job identity
    (hash of script/hosts/nproc/cwd, range 29400-30399) — stable across
    re-launches of the same job, distinct for different jobs sharing a
    head host. Open that range on the head's firewall, or pass an
    explicit ``port``."""
    hosts = list(hosts)
    cleanup: List[str] = []
    if coordinator is None:
        if all(_is_local(h) for h in hosts) and port is None:
            rdzv = rendezvous_dir()
            cleanup.append(rdzv)
            coordinator = "file://" + os.path.join(rdzv, "store")
        elif _is_local(hosts[0]):
            coordinator = f"127.0.0.1:{port or _free_port()}"
        else:
            if port is None:
                import hashlib
                digest = hashlib.sha1(
                    f"{script}|{','.join(hosts)}|{nproc}|{os.getcwd()}"
                    .encode()).digest()
                port = 29400 + int.from_bytes(digest[:2], "big") % 1000
            coordinator = f"{hosts[0].split('@')[-1]}:{port}"
    cmds = build_commands(hosts, nproc, coordinator, script, script_args,
                          python=python, ssh_cmd=ssh_cmd,
                          extra_env=extra_env,
                          simulate_devices=simulate_devices)
    procs = [subprocess.Popen(argv, env=env) for argv, env in cmds]
    return ProcessMonitor(procs, cleanup=cleanup)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(
        prog="zoo-launch",
        description="Launch a training script across hosts "
                    "(torch.distributed rendezvous env + supervision).")
    p.add_argument("--hosts", default=None,
                   help="comma-separated host list (default: "
                        "TPU_WORKER_HOSTNAMES, else localhost)")
    p.add_argument("--nproc", type=int, default=1,
                   help="processes (ranks) per host")
    p.add_argument("--coordinator", default=None,
                   help="host:port or file:///path rendezvous (default: a "
                        "file store for local hosts, else first host + "
                        "derived port)")
    p.add_argument("--port", type=int, default=None,
                   help="coordinator port when derived from --hosts")
    p.add_argument("--python", default=sys.executable)
    p.add_argument("--ssh-cmd", default="ssh",
                   help="remote-exec command (e.g. 'kubectl exec -i')")
    p.add_argument("--simulate-devices", type=int, default=0,
                   help="N>0: N CPU ranks per host (ZOO_DEVICE=cpu, gloo) "
                        "in place of --nproc")
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    hosts = ([h.strip() for h in args.hosts.split(",") if h.strip()]
             if args.hosts else detect_hosts())
    mon = launch(hosts, args.nproc, args.script, args.script_args,
                 coordinator=args.coordinator, port=args.port,
                 python=args.python, ssh_cmd=args.ssh_cmd,
                 simulate_devices=args.simulate_devices)
    codes = mon.wait(args.timeout)
    return max(codes) if codes else 0


if __name__ == "__main__":
    sys.exit(main())
