"""Port vs JAX package: vmatch's match rows rendered by torch ops over a
byte matrix (``vstree_tpu_torch/output/render.py::render_rows``) against
``vstree_tpu/output/render.py::render_matches``, the rows joined with a
newline after each, and against the port's own ``render_matches``.

Match tables and multisequences are made with numpy from a seed; the
text must be equal byte for byte (tolerance 0).  The renderer runs on
CPU tensors here, the same torch code as on a card; no JAX function is
compiled.
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.engine.match import MatchTable as JMatchTable
from vstree_tpu.output import render as jrender
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.engine.match import (
    FLAGPALINDROMIC,
    FLAGPPLEFTREVERSE,
    FLAGPPRIGHTREVERSE,
    FLAGQUERY,
    MatchTable,
)
from vstree_tpu_torch.output import render as trender

SEP = 0xFFFFFFFF
SHOWDESCS = {
    "none": None,
    "replaceblanks": {"skipprefix": 0, "maxlength": 12,
                      "untilfirstblank": False, "replaceblanks": True},
    "untilfirstblank": {"skipprefix": 0, "maxlength": 0,
                        "untilfirstblank": True, "replaceblanks": True},
    "maxlength": {"skipprefix": 0, "maxlength": 5,
                  "untilfirstblank": False, "replaceblanks": False},
    "skipprefix": {"skipprefix": 3, "maxlength": 9,
                   "untilfirstblank": False, "replaceblanks": True},
}
# E-values at the edges of format_evalue's quirk: 1e-99 and above get a
# blank more; 9.996e-100 prints as 1.00e-99 from below
EVALUES = (0.0, 1e-99, 9.99e-100, 9.996e-100, 1e100, np.inf, -0.0, np.nan,
           2.5e-7, 0.0312)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The renderer issues a few hundred small ops a chunk; a thread
    pool per test worker only makes the workers of one host wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _desc(rng) -> bytes:
    """A description with blanks, tabs and bytes above 127."""
    chars = np.frombuffer(b"abcXYZ09_ \t|\xe9\xff", np.uint8)
    return chars[rng.integers(0, chars.size, int(rng.integers(0, 20)))
                 ].tobytes() + b"\n"


def _multiseq(rng, nseq: int, nfiles: int, nquery: int = 0,
              descs: bool = True) -> dict:
    """The fields of a multisequence that the renderer reads: ``nfiles``
    files over ``totallength``, the last ``nquery`` sequences indexed
    queries; the last few sequences have no description."""
    total = int(rng.integers(20_000, 5_000_000))
    seps = sorted(rng.choice(total, nfiles - 1, replace=False).tolist())
    fields = {
        "totallength": total, "numofsequences": nseq,
        "filenames": [f"dir/file{i}.fna" for i in range(nfiles - 1)]
        + ["läst.fna"],
        "filesep": seps + [SEP],
        "descriptions": ([_desc(rng) for _ in range(nseq - 2)]
                         if descs else []),
        "numofquerysequences": nquery,
    }
    if nquery:
        fields["numofqueryfiles"] = 1
        fields["totalquerylength"] = int(total // 3)
    return fields


def _table(rng, n: int, ms: dict, query: dict | None) -> dict:
    """``n`` rows with every column the renderer reads; positions span
    the files (separators included) and beyond the widths, distances
    and scores run negative, every mode char occurs."""
    def pos(m):
        seps = np.array(m["filesep"][:-1], np.int64)
        anywhere = rng.integers(0, m["totallength"] + 2, n)
        at_sep = np.concatenate([seps, seps + 1, [0]])[
            rng.integers(0, seps.size * 2 + 1, n)]
        return np.where(rng.random(n) < 0.3, at_sep, anywhere)

    other = query if query is not None else ms
    flag = rng.choice([0, FLAGQUERY, FLAGPALINDROMIC,
                       FLAGQUERY | FLAGPALINDROMIC, FLAGPPLEFTREVERSE,
                       FLAGPPRIGHTREVERSE,
                       FLAGPPLEFTREVERSE | FLAGPPRIGHTREVERSE], n)
    length = rng.integers(1, 200, n)
    wide = rng.random(n) < 0.1
    length[wide] = rng.integers(100, 200_000, int(wide.sum()))
    return {
        "length1": length,
        "position1": pos(ms),
        "length2": np.maximum(length + rng.integers(-3, 4, n), 1),
        "position2": pos(other),
        "distance": rng.choice([0, 0, 1, 2, -1, -2, 7, 999, 1000, 1500,
                                -99, -100, -150], n),
        "flag": flag,
        "seqnum1": rng.integers(0, ms["numofsequences"], n),
        "relpos1": rng.integers(0, 10 ** int(rng.integers(1, 8)), n),
        "seqnum2": rng.integers(0, other["numofsequences"], n),
        "relpos2": rng.integers(0, 10 ** int(rng.integers(1, 8)), n),
        "evalue": np.where(rng.random(n) < 0.5,
                           np.array(EVALUES)[rng.integers(0, len(EVALUES),
                                                          n)],
                           10.0 ** rng.uniform(-120, 5, n)),
        "idnumber": np.arange(n),
        "transnum": np.where(rng.random(n) < 0.4, rng.integers(0, 6, n), -1),
    }


def _render_both(table: dict, ms: dict, query: dict | None, digits: dict,
                 showmode: int, showdesc: dict | None) -> tuple[str, str]:
    """(the JAX package's rows, newline-joined; the port's render_rows)
    of the same inputs."""
    jq = JMultiseq(**query) if query is not None else None
    want = "".join(line + "\n" for line in jrender.render_matches(
        JMatchTable(**table), JMultiseq(**ms), jrender.Digits(**digits),
        showmode, jq, showdesc))
    tq = Multiseq(**query) if query is not None else None
    mt, tms, td = MatchTable(**table), Multiseq(**ms), trender.Digits(**digits)
    plain = "".join(line + "\n" for line in trender.render_matches(
        mt, tms, td, showmode, tq, showdesc))
    assert plain == want
    got = trender.render_rows(mt, tms, td, showmode, tq, showdesc,
                              torch.device("cpu"))
    return want, got


def _case(seed: int, nquery: int = 0):
    rng = np.random.default_rng(seed)
    ms = _multiseq(rng, 40, 3, nquery)
    query = _multiseq(rng, 25, 2)
    digits = {"length": int(rng.integers(2, 6)),
              "position1": int(rng.integers(1, 7)),
              "seqnum1": int(rng.integers(1, 3)),
              "position2": int(rng.integers(1, 7)),
              "seqnum2": int(rng.integers(1, 3))}
    return rng, ms, query, digits


@pytest.mark.parametrize("showmode", range(64))
def test_every_show_mode_query_and_showdesc(showmode):
    """All six SHOW* bits in every combination, each with and without a
    query multisequence and with every -showdesc form (indexed query
    sequences in the odd modes)."""
    rng, ms, query, digits = _case(showmode, nquery=8 * (showmode % 2))
    for q in (None, query):
        table = _table(rng, 60, ms, q)
        for sd in SHOWDESCS.values():
            want, got = _render_both(table, ms, q, digits, showmode, sd)
            assert got == want
            assert got.count("\n") == 60


def test_edge_rows():
    """Negative distances and scores, values wider than their widths
    (distance >= 1000 and <= -100), the E-values and identities at the
    edges of their formats, every mode char."""
    rng, ms, _, digits = _case(101)
    digits = {"length": 2, "position1": 2, "seqnum1": 1, "position2": 2,
              "seqnum2": 1}
    # (length1, length2, distance) for identity 100.0, 99.995, 99.994,
    # a negative score, a negative identity, widened fields
    shapes = [(20, 20, 0), (20_000, 20_000, 1), (50_000, 3, 3),
              (10, 12, 100), (5, 5, 1500), (123_456, 7, -100),
              (3, 3, -150), (4, 4, 1000), (99, 100, -1), (1, 1, 999)]
    n = len(shapes) * len(EVALUES)
    table = _table(rng, n, ms, None)
    for j, (l1, l2, d) in enumerate(shapes):
        rows = slice(j * len(EVALUES), (j + 1) * len(EVALUES))
        table["length1"][rows], table["length2"][rows] = l1, l2
        table["distance"][rows] = d
        table["evalue"][rows] = EVALUES
    table["seqnum1"][:3] = [10 ** 6, -5, 0]
    table["relpos2"][:3] = [-7, 10 ** 12, 2 ** 62]
    mt = MatchTable(**table)
    assert {"D", "P", "F", "G", "H", "I"} <= set(mt.mode_chars())
    assert (mt.score < 0).any() and (mt.distance <= -100).any()
    for showmode in (0, trender.SHOWABSOLUTE, trender.SHOWFILE):
        want, got = _render_both(table, ms, None, digits, showmode, None)
        assert got == want
    # a last file that ends before the last positions: they are its own
    bounded = dict(ms, filesep=ms["filesep"][:-1] + [ms["totallength"] - 1])
    table["position1"][:5] = ms["totallength"] + np.arange(5)
    want, got = _render_both(table, bounded, None, digits, trender.SHOWFILE,
                             None)
    assert got == want
    for frag in ("100.00", "99.99", "1.00e-99", "1.00e+100", "inf", "nan",
                 " -150", "1500", "-0.00e+00", " 1000"):
        assert frag in want


@pytest.mark.parametrize("with_query", [False, True],
                         ids=["indexed-queries", "query-multiseq"])
def test_showfile_over_several_files(with_query):
    """-f over five database files, and the query's files or indexed
    query sequences (positions of database rows offset past the
    database)."""
    rng = np.random.default_rng(7)
    ms = _multiseq(rng, 50, 5, nquery=0 if with_query else 12)
    query = _multiseq(rng, 20, 4) if with_query else None
    digits = {"length": 3, "position1": 6, "seqnum1": 2, "position2": 6,
              "seqnum2": 2}
    table = _table(rng, 400, ms, query)
    if not with_query:
        # database rows whose offset position lands on a separator
        seps = np.array(ms["filesep"][:-1], np.int64)
        offset = ms["totallength"] - ms["totalquerylength"]
        table["flag"][:100] &= ~FLAGQUERY
        table["position2"][:100] = np.clip(
            seps[np.arange(100) % seps.size] - offset + np.arange(100) % 3,
            0, None)
    for showmode in (trender.SHOWFILE, trender.SHOWFILE
                     | trender.SHOWABSOLUTE):
        for sd in (None, SHOWDESCS["replaceblanks"]):
            want, got = _render_both(table, ms, query, digits, showmode, sd)
            assert got == want
            assert len({line.split()[1] for line in want.splitlines()}) > 1


def test_descriptions_absent_and_rebased():
    """A multisequence without descriptions prints ``sequence<n>``; with
    indexed queries the database's descriptions are rebased."""
    rng = np.random.default_rng(11)
    ms = _multiseq(rng, 30, 2, nquery=10)
    bare = _multiseq(rng, 30, 1, descs=False)
    digits = {"length": 2, "position1": 5, "seqnum1": 2, "position2": 5,
              "seqnum2": 2}
    for m in (ms, bare):
        table = _table(rng, 80, m, None)
        table["seqnum2"][:5] = m["numofsequences"] + np.arange(5)
        for sd in SHOWDESCS.values():
            want, got = _render_both(table, m, None, digits, 0, sd)
            assert got == want
    assert "sequence" in _render_both(table, bare, None, digits, 0,
                                      SHOWDESCS["maxlength"])[1]


def test_empty_table():
    rng, ms, query, digits = _case(3)
    table = {k: v[:0] for k, v in _table(rng, 5, ms, query).items()}
    for showmode in (0, 63):
        want, got = _render_both(table, ms, query, digits, showmode,
                                 SHOWDESCS["skipprefix"])
        assert got == want == ""


@pytest.mark.parametrize("showmode", [0, trender.SHOWFILE
                                      | trender.SHOWNOEVALUE, 45])
def test_chunks(showmode, monkeypatch):
    """Seven rows a chunk, 61 bytes a compaction: each chunk's own
    widths and tables, the text the same."""
    monkeypatch.setattr(trender, "_RENDER_ROWS", 7)
    monkeypatch.setattr(trender, "_COMPACT", 61)
    rng, ms, query, digits = _case(5 + showmode)
    table = _table(rng, 101, ms, query)
    want, got = _render_both(table, ms, query, digits, showmode,
                             SHOWDESCS["untilfirstblank"])
    assert got == want
    chunks = list(trender.render_row_chunks(
        MatchTable(**table), Multiseq(**ms), trender.Digits(**digits),
        showmode, Multiseq(**query), SHOWDESCS["untilfirstblank"], "cpu"))
    assert len(chunks) == 15
    assert [c.count("\n") for c in chunks] == [7] * 14 + [3]


def test_unusual_column_types():
    """Columns as NumPy gives them elsewhere (int32, uint32, float32
    E-values) render as the original renders them."""
    rng, ms, query, digits = _case(9)
    table = _table(rng, 50, ms, query)
    for name in ("length1", "relpos1", "seqnum2"):
        table[name] = table[name].astype(np.int32)
    table["position1"] = table["position1"].astype(np.uint32)
    with np.errstate(over="ignore"):
        table["evalue"] = table["evalue"].astype(np.float32)
    want, got = _render_both(table, ms, query, digits, 0, None)
    assert got == want


def test_a_device_it_cannot_use_raises():
    """The renderer runs on the device it is given or raises; it does
    not fall back to the host."""
    rng, ms, query, digits = _case(13)
    table = _table(rng, 10, ms, None)
    with pytest.raises((NotImplementedError, RuntimeError)):
        trender.render_rows(MatchTable(**table), Multiseq(**ms),
                            trender.Digits(**digits), 0, None, None, "meta")

