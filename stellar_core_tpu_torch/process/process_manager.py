"""ProcessManager: async `system()` — spawn shell commands, track exits
from the main loop (ref src/process/ProcessManagerImpl.cpp:825
posix_spawnp + SIGCHLD on the asio loop; MAX_CONCURRENT_SUBPROCESSES).

The reference uses this for history-archive get/put transfers (curl/aws);
command-template archives route through RunCommandWork here."""
from __future__ import annotations

import shlex
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

from ..work.work import BasicWork, State

MAX_CONCURRENT_SUBPROCESSES = 16


class ProcessExit:
    def __init__(self, pid: int, status: int):
        self.pid = pid
        self.status = status

    @property
    def ok(self) -> bool:
        return self.status == 0


class ProcessManager:
    def __init__(self, app=None,
                 max_concurrent: int = MAX_CONCURRENT_SUBPROCESSES):
        self.app = app
        self.max_concurrent = max_concurrent
        self.running: Dict[int, Tuple[subprocess.Popen, Callable]] = {}
        self.pending: List[Tuple[List[str], Callable]] = []
        self.total_spawned = 0

    def run_command(self, cmd: str,
                    on_exit: Optional[Callable] = None) -> None:
        """Queue a shell command; on_exit(ProcessExit) fires from poll()
        (ref ProcessManager::runProcess)."""
        argv = shlex.split(cmd)
        self.pending.append((argv, on_exit or (lambda e: None)))
        self._maybe_spawn()

    def _maybe_spawn(self) -> None:
        while self.pending and len(self.running) < self.max_concurrent:
            argv, cb = self.pending.pop(0)
            try:
                proc = subprocess.Popen(
                    argv, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)
            except OSError:
                cb(ProcessExit(-1, 127))
                continue
            self.total_spawned += 1
            self.running[proc.pid] = (proc, cb)

    def poll(self) -> int:
        """Reap exited children; fire callbacks (the SIGCHLD handler
        equivalent, pumped from Application.crank)."""
        done = []
        for pid, (proc, cb) in list(self.running.items()):
            rc = proc.poll()
            if rc is not None:
                done.append((pid, rc, cb))
        for pid, rc, cb in done:
            del self.running[pid]
            cb(ProcessExit(pid, rc))
        self._maybe_spawn()
        return len(done)

    def wait_all(self, crank=None, limit: int = 100000) -> None:
        """Drain everything (tests / synchronous callers)."""
        import time

        for _ in range(limit):
            if not self.running and not self.pending:
                return
            if self.poll() == 0:
                time.sleep(0.005)
            if crank is not None:
                crank()

    def shutdown(self) -> None:
        for proc, _cb in self.running.values():
            proc.kill()
        self.running.clear()
        self.pending.clear()


class RunCommandWork(BasicWork):
    """One subprocess as a Work item (ref historywork/RunCommandWork):
    WAITING until the command exits, then SUCCESS/FAILURE."""

    def __init__(self, pm: ProcessManager, cmd: str, name: str = ""):
        super().__init__(name or f"run:{cmd[:32]}",
                         max_retries=BasicWork.RETRY_A_FEW)
        self.pm = pm
        self.cmd = cmd
        self._result: Optional[ProcessExit] = None
        self._started = False

    def on_reset(self) -> None:
        self._result = None
        self._started = False

    def on_run(self) -> State:
        if not self._started:
            self._started = True

            def done(e: ProcessExit):
                self._result = e

            self.pm.run_command(self.cmd, done)
            return State.RUNNING
        self.pm.poll()
        if self._result is None:
            return State.RUNNING
        return State.SUCCESS if self._result.ok else State.FAILURE
