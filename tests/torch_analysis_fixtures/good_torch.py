"""Sanctioned torch shapes: everything here passes LGB005, LGB008, LGB010
and LGB013 clean — each mirrors a pattern the port uses.  Parsed by the
analyzer in tests, never imported."""

import multiprocessing as mp
import selectors
import time

import torch.distributed as dist

from lightgbm_tpu_torch import native


def symmetric_reduce(mesh, x):
    # a rank-conditioned branch with the same collectives on both sides
    if dist.get_rank() == 0:
        y = mesh.psum(x * 2, "data")
    else:
        y = mesh.psum(x, "data")
    return y


def root_logs(mesh, x):
    # a rank condition around host work only
    y = mesh.psum(x, "data")
    if mesh.rank == 0:
        print(y)
    return y


class Pool:
    # the parallel/launch.py shape: a list of processes joined in teardown
    def __init__(self, fn, n):
        ctx = mp.get_context("spawn")
        self._procs = [ctx.Process(target=fn) for _ in range(n)]
        for p in self._procs:
            p.start()

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def run_and_join(fn):
    p = mp.get_context("spawn").Process(target=fn)
    p.start()
    p.join()


class Gateway:
    def __init__(self):
        self._sel = selectors.DefaultSelector()

    def close(self):
        self._sel.close()

    def _loop(self):
        while True:
            for key, _ in self._sel.select(timeout=0.25):
                self._read(key.fileobj)

    def _read(self, sock):
        try:
            return sock.recv(65536)
        except BlockingIOError:
            return b""


class Learner:
    def _capture(self, fn):
        return native.capture(object(), fn, None, "relaxed")

    def grow(self, st):
        t0 = time.perf_counter()            # the eager driver times
        self._capture(lambda: self._step(st))
        return time.perf_counter() - t0

    def _step(self, st):
        st.n += 1
