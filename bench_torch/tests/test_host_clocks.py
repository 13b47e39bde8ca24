"""The per-layer metrics that read the program's host clocks
(``bench_torch/host_clocks.py``;
``metrics/setup_{library,first_launch,builds}_s``,
``metrics/window_builds.*``):

- their ``BENCHMARK.json`` entries list the cells whose end-to-end metric
  they move: the set-up split and the window's builds every cell;
- a traced rehearsal of each cell prints every one its cell lists, the
  set-up split no more than the run's ``setup_s`` (which only an untraced
  line prints) and no build in the window;
- the readers sum set-up's builds (those no profiler recorded) by kind,
  count the build spans inside the window, and give nothing without a
  trace or without the program's tally.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from bench_torch import harness, host_clocks, run

SETUP = ("setup_library_s", "setup_first_launch_s", "setup_builds_s")
NEW = (*SETUP, "window_builds.bulk", "window_builds.stream")


def _bench():
    return json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


def _metric(bench, name):
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    return m


def test_entries_list_the_cells_of_the_metric_they_move():
    bench = _bench()
    cells = [w["name"] for w in bench["workloads"]]
    moved = {m["name"]: m for m in bench["end_to_end"]}
    for name in NEW:
        m = _metric(bench, name)
        assert m["workloads"] == moved[m["moves"]].get("workloads", cells), \
            name


@pytest.mark.parametrize("cell", ["p3_flat_bulk", "asrc5_bulk_32k",
                                  "asrc5_live_1k", "p2_cd16_1024trk",
                                  "p3_flat_int16", "c4b_chain_f64",
                                  "asrc5_bulk_f64"])
def test_traced_rehearsal_prints_the_host_clocks_of_its_cell(
        capsys, monkeypatch, cell):
    from art_tpu_torch.utils import spans as program
    # this run's set-up builds alone: the tally covers the process
    monkeypatch.setattr(program, "builds", {})
    window, runs = harness.window, []
    monkeypatch.setattr(harness, "window",
                        lambda r, *a: runs.append(r) or window(r, *a))
    code = run.main(["--rehearse", "--workload", cell, "--seed",
                     "2900000033", "--seconds", "0.3", "--trace", "1"])
    assert code == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    got = result["metrics"]
    bench = _bench()
    for name in NEW:
        assert (name in got) == (cell in _metric(bench, name)["workloads"]), \
            name
    kind = "stream" if cell == "asrc5_live_1k" else "bulk"
    assert got[f"window_builds.{kind}"]["value"] == 0
    (r,) = runs
    assert sum(got[name]["value"] for name in SETUP) <= r.setup_s
    assert got["setup_builds_s"]["value"] > 0


def _program(builds=None):
    return SimpleNamespace(builds=builds or {})


def _run(ops=(), window=(0, 1000)):
    trace = SimpleNamespace(window=window, ops=sorted(ops))
    return SimpleNamespace(trace=trace)


def test_readers_sum_setup_and_count_the_window(monkeypatch):
    builds = {("library", False): [2, 3_000_000_000],
              ("first_launch", False): [5, 250_000_000],
              ("bank", False): [1, 40_000_000],
              ("matrix", False): [3, 2_000_000],
              ("matrix", True): [1, 7_000_000],
              ("hulls", False): [1, 500_000]}
    monkeypatch.setattr(host_clocks, "_program",
                        lambda: _program(builds))
    B, P = host_clocks.BUILD, "art.engine.plan"
    r = _run([(100, 400, P), (600, 900, P), (-50, 20, B + "matrix"),
              (200, 300, B + "matrix"), (990, 1200, B + "hulls"),
              (1000, 1100, B + "bank"), (300, 350, "art.engine.call")])
    read = lambda name: harness.read_metric(name, r)   # noqa: E731
    assert read("setup_library_s") == pytest.approx(3.0)
    assert read("setup_first_launch_s") == pytest.approx(0.25)
    assert read("setup_builds_s") == pytest.approx(0.0425)
    assert read("window_builds.bulk") == read("window_builds.stream") == 2


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_a_trace_or_a_tally(monkeypatch, name):
    monkeypatch.setattr(host_clocks, "_program", lambda: _program(
        {("library", False): [1, 10]}))
    assert harness.read_metric(name, SimpleNamespace(trace=None)) is None
    traced = _run([(10, 20, "art.engine.plan")])
    assert harness.read_metric(name, traced) is not None
    monkeypatch.setattr(host_clocks, "_program", lambda: None)
    assert harness.read_metric(name, traced) is None


def test_a_program_without_the_tally_is_no_program(monkeypatch):
    import art_tpu_torch.utils.spans as program
    assert host_clocks._program() is program
    monkeypatch.delattr(program, "builds")
    assert host_clocks._program() is None
