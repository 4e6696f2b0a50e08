"""Seeded LGB013 violation — a spawned process never joined.  This file
is ONLY an analysis-pass fixture; nothing imports it."""

import multiprocessing as mp


def spawn_and_forget(fn):
    ctx = mp.get_context("spawn")
    # BAD: started, never joined: it outlives the caller's teardown
    p = ctx.Process(target=fn)
    p.start()
    return None
