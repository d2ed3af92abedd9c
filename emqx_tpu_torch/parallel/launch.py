"""Start the ranks of a ('dp', 'tp') mesh: one forked process a rank.

    python -m emqx_tpu_torch.parallel.launch --world 4 --tp 2 \\
        --backend gloo [--device cpu] [--timeout 600] [--out results.pkl] \\
        TARGET [SETUP]

TARGET and SETUP are ``module:function`` or ``path/to/file.py:function``.
The launcher imports them, runs ``SETUP()`` once (when given: building the
host tables, in this process, before any rank exists), then forks `world`
ranks. Each rank joins the process group through a `FileStore` in a fresh
temporary directory (no TCP port, so parallel launches never collide),
makes its `Mesh` and runs ``TARGET(mesh)`` or ``TARGET(mesh, state)`` with
the setup's result. Every rank's return value is pickled to a file; `run`
returns them in rank order (`--out` pickles the list to a path).

The ranks share the host tables copy-on-write. For that the launching
process must not have touched CUDA or run a torch operation before the
fork (a forked CUDA context is unusable, a forked OpenMP pool can hang):
`run` only imports torch and builds the kernel library (`nvcc`, no CUDA
call) before forking. The whole launch has one timeout; when a rank fails
or the time runs out every rank is killed and `LaunchError` names the
rank that failed first, its exit code and the tail of its standard error.
A failed rank never yields a partial result.

Backends are the caller's choice (`mesh.rank_device`): NCCL one GPU a
rank; gloo any number of ranks, on the CPU or sharing GPUs.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

TAIL_BYTES = 4000
FAIL_GRACE_S = 1.0  # after a failure, how long the others may take to fail too


class LaunchError(RuntimeError):
    """A rank failed or the launch timed out: every rank was killed."""

    def __init__(self, rank: Optional[int], code: int, tail: str):
        self.rank, self.code, self.tail = rank, code, tail
        who = f"rank {rank}" if rank is not None else "the launch"
        super().__init__(f"{who} failed with exit code {code}\n{tail}")


def load_target(spec: str) -> Callable:
    """``module:function`` or ``path/to/file.py:function`` -> the function."""
    where, _, name = spec.rpartition(":")
    if not where or not name:
        raise ValueError(f"target {spec!r}: expected module:function or file.py:function")
    if where.endswith(".py"):
        path = Path(where).resolve()
        mod_name = "_launch_" + path.stem
        loader = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(loader)
        sys.modules[mod_name] = mod
        loader.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def _failed_at(work: Path, rank: int) -> float:
    try:
        return float((work / f"rank{rank}.failed").read_text())
    except (OSError, ValueError):
        return float("inf")  # killed by a signal: no time of its own


def _tail(path: Path) -> str:
    try:
        data = path.read_bytes()
    except OSError:
        return ""
    return data[-TAIL_BYTES:].decode(errors="replace")


def _child(rank: int, world: int, fn, state, has_state: bool, work: Path, *,
           backend: str, tp, device, timeout: float) -> None:
    """A rank's life; never returns."""
    code = 1
    try:
        err = os.open(work / f"rank{rank}.err", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.dup2(err, 2)
        sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
        import torch

        from emqx_tpu_torch.parallel.mesh import init_mesh

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh = init_mesh(rank, world, backend=backend, tp=tp, device=device,
                         store_path=str(work / "store"), timeout_s=timeout)
        res = fn(mesh, state) if has_state else fn(mesh)
        tmp = work / f"result{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, work / f"result{rank}.pkl")
        code = 0
    except BaseException:  # noqa: BLE001 - reported through stderr and the code
        # when a rank fails its peers fail soon after (their collectives
        # lose it): the earliest failure is the one the launcher reports
        (work / f"rank{rank}.failed").write_text(repr(time.monotonic()))
        traceback.print_exc()
    finally:
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        finally:
            os._exit(code)


def _kill(pids) -> None:
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in pids:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def run(fn: Callable, world: int, *, backend: str, tp: Optional[int] = None,
        device=None, timeout: float = 600.0, setup: Optional[Callable] = None,
        state=None) -> List:
    """Run `fn` on `world` forked ranks; -> every rank's return value, in
    rank order. `setup()` (or the given `state`) is built here, once, and
    shared copy-on-write; `fn` is called as ``fn(mesh, state)`` when either
    is given, else ``fn(mesh)``. Raises `LaunchError` when any rank fails
    or the launch outlives `timeout` seconds."""
    import torch  # noqa: F401 - imported before the fork, so no rank pays it

    if world < 1:
        raise ValueError(f"world {world}")
    has_state = setup is not None or state is not None
    if setup is not None:
        state = setup()
    if device is None or not str(device).startswith("cpu"):
        from emqx_tpu_torch.kernels import build

        build.library_path()  # nvcc only: the ranks just load it
    work = Path(tempfile.mkdtemp(prefix="emqx-mesh-"))
    deadline = time.monotonic() + timeout
    pids: dict = {}
    try:
        sys.stdout.flush()
        sys.stderr.flush()
        for rank in range(world):
            pid = os.fork()
            if pid == 0:
                _child(rank, world, fn, state, has_state, work, backend=backend,
                       tp=tp, device=device, timeout=timeout)
            pids[pid] = rank
        live = dict(pids)
        while live:
            pid, status = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                if time.monotonic() > deadline:
                    _kill(list(live))
                    tails = "\n".join(f"-- rank {r}:\n{_tail(work / f'rank{r}.err')}"
                                      for r in sorted(pids.values()))
                    raise LaunchError(None, 124, f"timed out after {timeout} s\n{tails}")
                time.sleep(0.02)
                continue
            if pid not in live:
                continue
            rank = live.pop(pid)
            code = os.waitstatus_to_exitcode(status)
            if code != 0:
                codes = {rank: code}
                grace = time.monotonic() + FAIL_GRACE_S
                while live and time.monotonic() < grace:
                    pid, status = os.waitpid(-1, os.WNOHANG)
                    if pid in live:
                        codes[live.pop(pid)] = os.waitstatus_to_exitcode(status)
                    else:
                        time.sleep(0.02)
                _kill(list(live))
                rank = min((r for r, c in codes.items() if c != 0),
                           key=lambda r: (_failed_at(work, r), r))
                raise LaunchError(rank, codes[rank], _tail(work / f"rank{rank}.err"))
        out = []
        for rank in range(world):
            with open(work / f"result{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m emqx_tpu_torch.parallel.launch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default cuda)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None, help="pickle every rank's result here")
    ap.add_argument("target", help="module:function or file.py:function, run on every rank")
    ap.add_argument("setup", nargs="?", default=None,
                    help="module:function run once before the ranks start")
    args = ap.parse_args(argv)
    fn = load_target(args.target)
    setup = load_target(args.setup) if args.setup else None
    try:
        res = run(fn, args.world, backend=args.backend, tp=args.tp,
                  device=args.device, timeout=args.timeout, setup=setup)
    except LaunchError as e:
        print(str(e), file=sys.stderr)
        return e.code if 0 < e.code < 256 else 1
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
