"""PyTorch port: the serving CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) with the same flags, closed loop on
small seeded corpora, the port on the CPU.  Every printed line is equal once
the wall-clock fields (queries/s, p50/p99, the stage split) are masked: the
corpus and serving lines, hit rate, padding, shapes, per-plan counts,
routing fan-out, the byte counters, the export lines and recall@10.  The exported files hold
the same counters, audit records and events (times aside), and both
validators accept the port's trace."""
import json
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as ref_serve  # noqa: E402
from repro.obs import validate_trace as ref_validate_trace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import validate_trace  # noqa: E402

EXPORTS = ["--trace-out", "T.json", "--metrics-out", "M.json", "--audit-out", "A.jsonl",
           "--events-out", "E.jsonl"]
CONFIGS = {
    "k_sweep": ["--queries", "128"],
    "auto_mixture": ["--queries", "64", "--trace", "mixture", "--algorithm", "auto",
                     "--prune", "--fused"],
    "sharded_footprint": ["--queries", "32", "--shards", "3", "--partition", "region",
                          "--routing", "footprint", "--prune"],
}
WALL = [
    (re.compile(r"qps=[\d,.]+"), "qps=*"),
    (re.compile(r"p50=[\d.]+ms"), "p50=*"),
    (re.compile(r"p99=[\d.]+ms"), "p99=*"),
    (re.compile(r"p50/p99=[\d.]+/[\d.]+ms"), "p50/p99=*"),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked(text: str) -> list[str]:
    lines = text.splitlines()
    for pat, rep in WALL:
        lines = [pat.sub(rep, line) for line in lines]
    return lines


def _run(main, argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    main(argv)
    out = capsys.readouterr().out
    files = {name: (tmp_path / name).read_text() for name in EXPORTS[1::2]}
    return out, files


def _jsonl(text, drop):
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in text.splitlines()]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cli_equals_reference(config, tmp_path, monkeypatch, capsys):
    argv = ["--n-docs", "3000", *CONFIGS[config], *EXPORTS]
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()

    def ref_main(args):
        monkeypatch.setattr(sys, "argv", ["serve", *args])
        ref_serve.main()

    want, want_files = _run(ref_main, argv, tmp_path / "ref", monkeypatch, capsys)
    got, got_files = _run(serve.main, [*argv, "--device", "cpu"], tmp_path / "port",
                          monkeypatch, capsys)
    assert _masked(got) == _masked(want)
    assert any(line.startswith("recall@10 vs oracle = ") for line in got.splitlines())

    m, ref_m = json.loads(got_files["M.json"]), json.loads(want_files["M.json"])
    assert m["counters"] == ref_m["counters"] and m["gauges"] == ref_m["gauges"]
    assert m["histograms"].keys() == ref_m["histograms"].keys()
    # closed loop: the audit's planning times and the events' times are
    # wall clock
    assert _jsonl(got_files["A.jsonl"], {"t_plan_s"}) == _jsonl(want_files["A.jsonl"],
                                                                {"t_plan_s"})
    assert (config == "auto_mixture") == bool(got_files["A.jsonl"])
    assert _jsonl(got_files["E.jsonl"], {"t", "service_s"}) == _jsonl(want_files["E.jsonl"],
                                                                      {"t", "service_s"})
    trace = json.loads(got_files["T.json"])
    assert validate_trace(trace) == [] and ref_validate_trace(trace) == []


def test_cli_flags_and_errors_match_reference(capsys, monkeypatch):
    """The same 35 flags with the same defaults and choices, plus
    ``--device``; the same argument errors, raised before any build; and no
    CUDA with the default device raises, naming the opt-in."""
    def actions(mod):
        import argparse

        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            seen["ap"] = self
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        try:
            with pytest.raises(SystemExit):
                (mod.main([]) if mod is serve else mod.main())
        finally:
            monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
        return {a.dest: (a.option_strings, a.default, a.choices, a.type)
                for a in seen["ap"]._actions if a.dest != "help"}

    ref_flags, flags = actions(ref_serve), actions(serve)
    assert flags.pop("device")[1] == "cuda"
    assert flags == ref_flags and len(flags) == 35

    for bad in (["--workers", "2"], ["--routing", "footprint"]):
        monkeypatch.setattr(sys, "argv", ["serve", *bad])
        with pytest.raises(SystemExit):
            ref_serve.main()
        want = capsys.readouterr().err.splitlines()[-1]
        with pytest.raises(SystemExit):
            serve.main(bad)
        assert capsys.readouterr().err.splitlines()[-1] == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            serve.main(["--n-docs", "64"])
