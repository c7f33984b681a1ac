"""The port's vmatch entry point against the JAX CLI's ``main()``.

``vstree_tpu_torch.cli.vmatch.entry`` is what ``python -m
vstree_tpu_torch.cli.vmatch`` runs (its ``main`` passes the CUDA card);
here it gets the CPU.  Under every environment case it must exit with
the JAX ``main``'s code and print its stdout and stderr: the QUERYSPEEDUP
front check, the on/off checks of VMATCHSHOWTIMESPACE and
VSTREE_DEBUG_NANS in that order, and the timing mode, whose two lines are
compared by their format.  VSTREE_PROFILE is the port's alone here: the
JAX ``main`` is not run under it.
"""

import json
import re

import numpy as np
import pytest
import torch

from conftest import random_dna_text
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch

VARIABLES = ("QUERYSPEEDUP", "VMATCHSHOWTIMESPACE", "VSTREE_DEBUG_NANS",
             "VSTREE_PROFILE")
TIMING = re.compile(r"^# (TIME|SPACE) vmatch \d+\.\d\d$")

ENV_CASES = [
    {},
    {"QUERYSPEEDUP": "x2"},
    {"QUERYSPEEDUP": "-1"},
    {"QUERYSPEEDUP": "1"},
    {"QUERYSPEEDUP": "3"},
    {"QUERYSPEEDUP": "4"},
    {"QUERYSPEEDUP": "6"},
    {"QUERYSPEEDUP": "0"},
    {"QUERYSPEEDUP": "5"},
    {"VMATCHSHOWTIMESPACE": "on"},
    {"VMATCHSHOWTIMESPACE": "off"},
    {"VMATCHSHOWTIMESPACE": "1"},
    {"VSTREE_DEBUG_NANS": "off"},
    {"VSTREE_DEBUG_NANS": "yes"},
    # two bad variables: the first check in main's order speaks
    {"VMATCHSHOWTIMESPACE": "1", "QUERYSPEEDUP": "x2"},
    {"VSTREE_DEBUG_NANS": "yes", "VMATCHSHOWTIMESPACE": "1"},
]

TASKS = [
    ["-complete", "-q", "Q"],
    ["-l", "20"],
    ["-l", "20", "-s", "xml"],
    ["-l", "20", "-dbnomatch", "50"],
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops launch many small ops; a thread pool per test
    worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three DNA records with repeated stretches, queries sampled from
    them (some reverse-complemented, some random), and the port's
    index of the records."""
    tmp = tmp_path_factory.mktemp("entry")
    rng = np.random.default_rng(101)
    recs = ["".join("acgt"[c] for c in random_dna_text(rng, n))
            for n in (1500, 1100, 1800)]
    for dst, src, at, st, ln in ((2, 0, 700, 100, 80), (1, 0, 300, 900, 40),
                                 (0, 2, 1200, 50, 60), (1, 1, 800, 20, 30)):
        recs[dst] = (recs[dst][:at] + recs[src][st:st + ln]
                     + recs[dst][at + ln:])
    qs = []
    for i in range(30):
        src = recs[i % 3]
        ln = int(rng.integers(14, 30))
        st = int(rng.integers(0, len(src) - ln))
        q = src[st:st + ln]
        if i % 5 == 3:
            q = q[::-1].translate(str.maketrans("acgt", "tgca"))
        elif i % 5 == 4:
            q = "".join("acgt"[c] for c in random_dna_text(rng, ln))
        qs.append(q)
    index = str(tmp / "x")
    assert tmkvtree.run(["-db", _fasta(tmp / "x.fna", recs), "-dna", "-pl",
                         "-allout", "-indexname", index], "cpu") == 0
    return {"index": index, "Q": _fasta(tmp / "q.fna", qs), "tmp": tmp}


def _argv(data, task):
    return [data.get(a, a) for a in task] + [data["index"]]


def _outcome(call, capsys):
    """(exit code, stdout, stderr) of an entry point, which always
    exits."""
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        call()
    out, err = capsys.readouterr()
    return exc.value.code, out, err


def _jax_main(argv, capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["vmatch"] + argv)
    return _outcome(jvmatch.main, capsys)


def _port_entry(argv, capsys):
    return _outcome(lambda: tvmatch.entry(argv, lambda: "cpu",
                                          lambda: ["cpu"]), capsys)


@pytest.fixture
def env(monkeypatch):
    """A clean environment for the four variables; no XLA cache in
    HOME."""
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("VSTREE_COMPILE_CACHE", "off")
    return monkeypatch


@pytest.mark.parametrize("task", TASKS, ids=lambda t: "_".join(t))
@pytest.mark.parametrize("case", ENV_CASES,
                         ids=lambda c: "_".join(f"{k}={v}" for k, v in
                                                c.items()) or "unset")
def test_entry_equals_the_jax_main(data, task, case, env, capsys):
    for name, value in case.items():
        env.setenv(name, value)
    argv = _argv(data, task)
    want = _jax_main(argv, capsys, env)
    got = _port_entry(argv, capsys)
    if case.get("VMATCHSHOWTIMESPACE") == "on" and want[0] == 0:
        for outcome in (want, got):
            lines = outcome[1].splitlines()
            assert len(lines) == 2, outcome
            assert all(TIMING.match(line) for line in lines), lines
            assert [line.split()[1] for line in lines] == ["TIME", "SPACE"]
        want, got = want[0::2], got[0::2]
    assert got == want
    if not case or case in ({"VMATCHSHOWTIMESPACE": "off"},
                            {"VSTREE_DEBUG_NANS": "off"}):
        assert want[0] == 0 and want[1].count("\n") > 3


def test_profile_writes_a_trace_and_leaves_stdout(data, env, capsys,
                                                  tmp_path):
    """VSTREE_PROFILE=<dir>: one ``vmatch.<ns>.pt.trace.json`` in the
    directory with the run's ops, and the same stdout as without it."""
    argv = _argv(data, TASKS[0])
    plain = _port_entry(argv, capsys)
    env.setenv("VSTREE_PROFILE", str(tmp_path / "trace"))
    traced = _port_entry(argv, capsys)
    assert traced == plain and plain[0] == 0 and plain[1].count("\n") > 10
    files = list((tmp_path / "trace").glob("vmatch.*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    ops = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert len(events) > 10 and ops


def test_profile_in_the_timing_mode(data, env, capsys, tmp_path):
    """The trace nests inside the timing mode, as in the JAX ``main``:
    both lines, and the trace."""
    env.setenv("VMATCHSHOWTIMESPACE", "on")
    env.setenv("VSTREE_PROFILE", str(tmp_path))
    code, out, err = _port_entry(_argv(data, TASKS[1]), capsys)
    assert code == 0 and not err
    assert [TIMING.match(line).group(1) for line in out.splitlines()] == [
        "TIME", "SPACE"]
    assert len(list(tmp_path.glob("vmatch.*.pt.trace.json"))) == 1


def test_debug_nans_on_prints_the_rows(data, env, capsys):
    """VSTREE_DEBUG_NANS=on arms nothing in the port (no floating-point
    tensor leaves the device): the rows of the JAX ``main`` without it."""
    argv = _argv(data, TASKS[0])
    want = _jax_main(argv, capsys, env)
    env.setenv("VSTREE_DEBUG_NANS", "on")
    assert _port_entry(argv, capsys) == want and want[0] == 0


def test_main_requests_the_card_after_the_checks(data, env, capsys):
    """``main`` passes the CUDA card; a malformed variable is reported
    before it is requested, so without a card the message is the JAX
    ``main``'s, and with a clean environment the request raises."""
    env.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(data, TASKS[0])
    env.setattr("sys.argv", ["vmatch"] + argv)
    env.setenv("QUERYSPEEDUP", "x2")
    got = _outcome(tvmatch.main, capsys)
    assert got == _jax_main(argv, capsys, env)
    env.delenv("QUERYSPEEDUP")
    env.setattr("sys.argv", ["vmatch"] + argv)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tvmatch.main()
