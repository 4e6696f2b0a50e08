"""The port's program pass (`lightgbm_tpu_torch/analysis/programs.py`).

The sharded programs run once for the module (one tree each on gloo rank
pools of 2 and 4) and every check reads that one record:

  * the record matches the checked-in ``budgets.json`` and
    ``sequences.json``, and ``--dump-budgets`` / ``--dump-sequences``
    re-derive both byte for byte;
  * a doctored sequence (one collective moved, the count unchanged) and a
    doctored budget each fail the gate;
  * ``data`` at 2 and at 4 ranks issues the same (op, axis) order, every
    rank of a program the same order, and the quantized exchange moves at
    most half the float32 one's bytes;
  * ``Mesh.log`` is off by default;
  * the recompile sentinel's 2-D leg runs on four gloo ranks.
"""

import copy
import os

import pytest
import torch

from lightgbm_tpu_torch.analysis import (load_budgets, load_sequences,
                                         validate_findings_report)
from lightgbm_tpu_torch.analysis import programs
from lightgbm_tpu_torch.analysis.common import BUDGETS_PATH, SEQUENCES_PATH

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recs():
    return programs.run_programs()


def test_every_program_runs_and_matches_its_pins(recs):
    assert set(recs.logs) == set(programs.PROGRAMS) and not recs.skipped
    assert programs.run(recs) == []
    for name, logs in recs.logs.items():
        world = 1
        for d in programs.PROGRAMS[name][2]:
            world *= d
        assert len(logs) == world and len(logs[0]) > 0, name


def test_dump_rederives_the_checked_in_files_bytewise(recs, tmp_path):
    b, s = tmp_path / "budgets.json", tmp_path / "sequences.json"
    programs.dump_budgets(recs, str(b))
    programs.dump_sequences(recs, str(s))
    for out, pinned in ((b, BUDGETS_PATH), (s, SEQUENCES_PATH)):
        with open(pinned, "rb") as fh:
            assert out.read_bytes() == fh.read(), pinned


def test_gate_dumps_through_the_cli(recs, tmp_path, monkeypatch):
    """``--dump-budgets P --dump-sequences Q`` writes both from one run;
    the gate's programs pass reports every program in a valid report."""
    from lightgbm_tpu_torch.analysis import __main__ as gate
    monkeypatch.setattr(gate.programs, "run_programs",
                        lambda glob=None, only=None: recs)
    b, s = tmp_path / "b.json", tmp_path / "s.json"
    assert gate.main(["--dump-budgets", str(b), "--dump-sequences", str(s),
                      "--quiet"]) == 0
    with open(SEQUENCES_PATH, "rb") as fh:
        assert s.read_bytes() == fh.read()
    out = tmp_path / "r.json"
    assert gate.main(["--passes", "programs", "--json", str(out),
                      "--quiet"]) == 0
    import json
    rep = json.loads(out.read_text())
    assert validate_findings_report(rep) == []
    progs = rep["passes"]["programs"]["programs"]
    assert set(progs) == set(programs.PROGRAMS)
    assert progs["wave_sharded_data"]["collectives"]["psum_scatter"] > 0


def _moved(seq):
    """Swap the first collective with the first later one of another op:
    the same count, another order."""
    j = next(i for i, e in enumerate(seq) if e["op"] != seq[0]["op"])
    seq[0], seq[j] = seq[j], seq[0]


def test_doctored_sequence_fails(recs):
    pinned = load_sequences()
    name = "wave_sharded_data"
    moved = copy.deepcopy(pinned)
    _moved(moved["programs"][name])
    assert len(moved["programs"][name]) == len(pinned["programs"][name])
    found = programs.run(recs, sequences=moved)
    assert [(f.rule, f.symbol) for f in found] == [("collective-order",
                                                    name)]
    assert "collective 0" in found[0].message
    gone = copy.deepcopy(pinned)
    del gone["programs"][name]
    found = programs.check_sequences(recs, gone)
    assert [f.rule for f in found] == ["collective-order"]
    assert "no pinned sequence" in found[0].message


@pytest.mark.parametrize("key,rule", [
    ("calls", "collective-budget"), ("sites", "collective-sites"),
    ("bytes", "collective-payload")])
def test_doctored_budget_fails(recs, key, rule):
    budgets = copy.deepcopy(load_budgets())
    caps = budgets["programs"]["wave_sharded_voting"][key]
    op = sorted(caps)[0]
    caps[op] -= 1
    found = programs.run(recs, budgets=budgets)
    assert [(f.rule, f.symbol) for f in found] == [
        (rule, "wave_sharded_voting")]
    assert op in found[0].message


def test_data_order_same_at_2_and_4_ranks(recs):
    two, four = (programs.order_signature(recs.logs[n][0])
                 for n in programs.FACTORIZATION_GROUPS["data"])
    assert two == four and len(two) > 0
    # the shards differ, the schedule does not; each rank reduce-scatters
    # its whole member histograms at either width
    b2, b4 = (programs.stats(recs.logs[n][0])["bytes"]["psum_scatter"]
              for n in programs.FACTORIZATION_GROUPS["data"])
    assert b2 == b4 > 0
    assert programs.cross_factorization_findings(recs) == []
    doctored = programs.ProgramRecords()
    doctored.logs = dict(recs.logs)
    doctored.logs["wave_sharded_data_4"] = [
        recs.logs["wave_sharded_data_4"][0][1:]]
    found = programs.cross_factorization_findings(doctored)
    assert [f.rule for f in found] == ["collective-order-factorization"]


def test_ranks_agree_and_a_diverging_rank_fails(recs):
    for name, logs in recs.logs.items():
        ref = [(e["op"], e["axis"], e["dtype"]) for e in logs[0]]
        for log in logs[1:]:
            assert [(e["op"], e["axis"], e["dtype"]) for e in log] == ref
    doctored = programs.ProgramRecords()
    logs = copy.deepcopy(recs.logs["wave_sharded_2d"])
    _moved(logs[3])
    doctored.logs = {"wave_sharded_2d": logs}
    found = programs.check_sequences(doctored)
    assert [f.rule for f in found] == ["collective-order-ranks"]
    assert "rank 3" in found[0].message


def test_quantized_exchange_is_at_most_half(recs):
    q, f = (programs.stats(recs.logs[n][0])["bytes"]["psum_scatter"]
            for n in ("wave_sharded_data_quant", "wave_sharded_data"))
    assert 0 < 2 * q <= f
    assert programs.quant_payload_findings(recs) == []


def test_record_fields_and_axes(recs):
    """Each entry names op, axis, dtype, bytes and a site in the package;
    the 2-D program issues collectives over both axes."""
    entry = recs.logs["wave_sharded_2d"][0][0]
    assert set(entry) == {"op", "axis", "dtype", "bytes", "site"}
    assert entry["site"].split(":")[0].endswith(".py")
    axes = {e["axis"] for e in recs.logs["wave_sharded_2d"][0]}
    assert {"data", "feature"} <= axes
    assert {e["axis"] for e in recs.logs["wave_feature"][0]} == {"data"}


def test_mesh_log_off_by_default():
    """A mesh records nothing unless a list is set on ``log``."""
    from lightgbm_tpu_torch.parallel.sharding import log_entry, make_mesh
    mesh = make_mesh(1)
    assert mesh.log is None
    x = torch.ones(3, dtype=torch.int32)
    assert torch.equal(mesh.psum(x, "data"), x) and mesh.calls == 0
    e = log_entry("psum", None, x)
    assert e["axis"] == "*" and e["bytes"] == 12 and e["dtype"] == "int32"
    assert os.path.basename(__file__) in e["site"]


def test_recompile_2d_leg_on_four_ranks():
    """The sentinel's 2-D leg (run where four cards exist) as four gloo
    ranks on the CPU: every rank trains through the 2-D learner, which
    runs eagerly, so its capture counter stays 0."""
    from lightgbm_tpu_torch.analysis import recompile
    from lightgbm_tpu_torch.parallel.launch import RankPool
    with RankPool(4, "gloo", timeout_s=120) as pool:
        got = pool.run(recompile._leg_2d, 4, "cpu", timeout_s=120)
    assert got == [(0, 0, "ShardedWave2DLearner")] * 4
