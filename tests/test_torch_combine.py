"""Port vs JAX package: the seed extension's (dist, l, r, diag, diag)
combination on the device (``gextend._extend_combine_device``, torch ops
in ``gextend_dev.combine_fronts``) against the NumPy ``_extend_combine``.

The fronts come from the JAX package's host ``edit_fronts`` of every
seed (exact runs of at least L chars on a diagonal); the JAX package's
``_extend_combine`` and the port's device function on CPU tensors get
the same fronts and seeds, and every ``MatchTable`` column must be equal
(integers equal, dtypes equal; tolerance 0).  Cases: maxdist 1-3; self
comparison, a text against its per-record reverse complement (``-p``)
and a database against a query text; ``-allmax`` on and off; the
survivors in chunks of 1, of 7 and in one chunk; extensions that run
into a SEPARATOR or a text end; a text whose long copies take E-value 0,
so that combinations tie on the E-value and fall to identity and
length.  Last, ``vmatch -l 24 -e 2`` through the port's CLI with the
NumPy combination and the host fronts made to raise, byte for byte
against the JAX CLI.
"""

import io

import numpy as np
import pytest
import torch

from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu.engine import gextend as jgextend
from vstree_tpu.engine.match import MatchTable as JMatchTable
from vstree_tpu.stats.evalues import Evalues as JEvalues
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch
from vstree_tpu_torch.engine import gextend as tgextend
from vstree_tpu_torch.engine import gextend_dev as tgextend_dev
from vstree_tpu_torch.engine.match import MatchTable
from vstree_tpu_torch.stats.evalues import Evalues

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")
WILDCARD, SEPARATOR = 254, 255
MODES = {"self": (False, True), "p": (True, False), "query": (True, False)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The combination launches thousands of small ops; a thread pool
    per test worker only makes the workers of one host wait for each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mutated(rng, elem, sigma, nsub, nindel):
    copy = elem.tolist()
    for _ in range(nsub):
        copy[int(rng.integers(0, len(copy)))] = int(rng.integers(0, sigma))
    for _ in range(nindel):
        at = int(rng.integers(1, len(copy) - 1))
        if rng.integers(0, 2):
            del copy[at]
        else:
            copy.insert(at, int(rng.integers(0, sigma)))
    return np.asarray(copy, np.uint8)


def _put(text, at, piece):
    text[at:at + piece.size] = piece[:text.size - at]
    return at + piece.size


def _revcomp(elem):
    out = elem[::-1].copy()
    out[out < 4] = 3 - out[out < 4]
    return out


def _repeat_text(seed, n=3000, inverted=False):
    """DNA records holding edited copies of three elements (every other
    copy reverse-complemented with ``inverted``), one copy at either end
    of the text, one ending at a separator and one starting after the
    other separator, and a few wildcards."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n).astype(np.uint8)
    elems = [rng.integers(0, 4, ln).astype(np.uint8) for ln in (60, 90, 130)]
    at = 120
    for k in range(12):
        copy = _mutated(rng, elems[k % 3], 4, 1 + k % 2, k % 2)
        if inverted and k % 2:
            copy = _revcomp(copy)
        at = _put(text, at + int(rng.integers(5, 40)), copy)
    assert at < 2000
    _put(text, 0, _mutated(rng, elems[0], 4, 1, 0))
    end = _mutated(rng, elems[1], 4, 1, 1)
    _put(text, n - end.size, _revcomp(end) if inverted else end)
    seps = np.array([2300, 2650])
    last = _mutated(rng, elems[2], 4, 2, 0)
    _put(text, seps[0] - last.size, _revcomp(last) if inverted else last)
    _put(text, seps[1] + 1, _mutated(rng, elems[1], 4, 0, 1))
    text[seps] = SEPARATOR
    text[rng.choice(np.arange(150, 1900), 4, replace=False)] = WILDCARD
    return text


def _per_record_revcomp(text):
    """The reverse complement of every record in place (``-p``)."""
    out = text.copy()
    bounds = np.concatenate([[-1], np.flatnonzero(text == SEPARATOR),
                             [text.size]])
    for a, b in zip(bounds[:-1] + 1, bounds[1:]):
        rec = text[a:b][::-1].copy()
        rec[rec < 4] = 3 - rec[rec < 4]
        out[a:b] = rec
    return out


def _query_texts(seed, sigma=20):
    """A protein database text and a query text of edited pieces of it,
    starting and ending as the database does, with two separators."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, sigma, 2500).astype(np.uint8)
    a[[900, 1700]] = SEPARATOR
    b = rng.integers(0, sigma, 5000).astype(np.uint8)
    at = _put(b, 0, a[:70])
    for k in range(50):
        src = int(rng.integers(0, a.size - 130))
        piece = _mutated(rng, a[src:src + int(rng.integers(40, 110))],
                         sigma, 1, k % 3 == 0)
        piece[piece > sigma] = a[0]
        at = _put(b, at + int(rng.integers(0, 8)), piece)
    assert at < b.size - 80
    b[b.size - 80:] = a[a.size - 80:]
    b[[400, 2800]] = SEPARATOR
    return a, b


def _diagonal_seeds(a, b, L, self_pairs):
    """Every exact run of at least L chars on a diagonal of a against b
    (wildcards and separators match nothing): (pos1, pos2, length); for
    a self comparison the pairs with pos1 < pos2."""
    out = []
    lo = 1 if self_pairs else -(b.size - 1)
    for d in range(lo, a.size):
        # a[i] against b[i - d]
        i = np.arange(max(d, 0), min(a.size, b.size + d))
        eq = (a[i] == b[i - d]) & (a[i] < WILDCARD)
        edges = np.diff(np.concatenate([[0], eq.astype(np.int8), [0]]))
        for s, e in zip(np.flatnonzero(edges == 1),
                        np.flatnonzero(edges == -1)):
            if e - s >= L:
                p, q = int(i[s]), int(i[s] - d)
                out.append((q, p, e - s) if self_pairs else (p, q, e - s))
    out.sort()
    return tuple(np.array(col, np.int64) for col in zip(*out))


def _seed_table(cls, p1, p2, sl):
    z = np.zeros(p1.size, np.int64)
    return cls(length1=sl.copy(), position1=p1.copy(), length2=sl.copy(),
               position2=p2.copy(), distance=z.copy(), flag=z + 1,
               seqnum1=z.copy(), relpos1=p1.copy(), seqnum2=z.copy(),
               relpos2=p2.copy(), evalue=np.zeros(p1.size, np.float64),
               idnumber=z.copy(), transnum=z - 1)


class Case:
    """Two texts (the same array for a self comparison), both packages'
    Seqs, the seeds (exact runs of at least L chars on a diagonal) and
    the least length of an extension."""

    def __init__(self, a, b, sigma, L, least):
        self.a, self.b, self.L, self.least = a, b, L, least
        self.jsq = jgextend.Seqs(a, b)
        self.tsq = tgextend.Seqs(a, b, "cpu")
        self.sigma = sigma
        self.seeds = _diagonal_seeds(a, b, L, b is a)

    def fronts(self, maxdist, sel):
        """The JAX package's host fronts of the seeds ``sel``."""
        p1, p2, sl = (col[sel] for col in self.seeds)
        sq = self.jsq
        lf, hl = jgextend.edit_fronts(sq, p1 - 1, p2 - 1, p1, p2, maxdist,
                                      forward=False, reachlength=self.L)
        rf, hr = jgextend.edit_fronts(sq, p1 + sl, p2 + sl,
                                      sq.n1 - (p1 + sl), sq.n2 - (p2 + sl),
                                      maxdist, forward=True,
                                      reachlength=None)
        return (p1, p2, sl), (lf, hl, rf, hr)


def _long_copies_text(seed):
    """Three copies of a 700-char element: the second with a
    substitution, the third with an insertion.  The extensions across an
    edit and a few chars into the flanks run past the E-value table's
    rows (E-value 0), so combinations tie on the E-value."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, 3000).astype(np.uint8)
    elem = rng.integers(0, 4, 700).astype(np.uint8)
    sub = elem.copy()
    sub[300] = (sub[300] + 1) % 4
    ins = np.insert(elem, 450, (elem[450] + 1) % 4)
    for at, copy in ((50, elem), (950, sub), (1850, ins)):
        _put(text, at, copy)
    return text


@pytest.fixture(scope="module")
def cases():
    """Self, ``-p`` and query texts, and the long copies."""
    selftext = _repeat_text(5)
    pal = _repeat_text(6, inverted=True)
    qa, qb = _query_texts(7)
    longtext = _long_copies_text(8)
    return {"self": Case(selftext, selftext, 4, 8, 24),
            "p": Case(pal, _per_record_revcomp(pal), 4, 8, 24),
            "query": Case(qa, qb, 20, 6, 20),
            "long": Case(longtext, longtext, 4, 12, 30)}


def _device_args(sq, seeds, fronts):
    """The fronts as the device function takes them: int32 tensors with
    the device sentinel; the rest int64 tensors."""
    lf, hl, rf, hr = fronts

    def dev32(f):
        return torch.from_numpy(
            np.where(f <= jgextend.NEG, tgextend_dev.NEG32, f).astype(
                np.int32)).to(sq.device)

    def dev64(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(sq.device)

    return (dev32(lf), dev64(hl), dev32(rf), dev64(hr),
            *(dev64(c) for c in seeds))


def _survivors(seeds):
    """The survivor index as the key column."""
    return torch.arange(seeds[0].size)[None]


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _both(case, maxdist, mode, allmax, sel):
    """(device function's table, the JAX package's _extend_combine's)."""
    qc, selfmode = MODES[mode]
    seeds, fronts = case.fronts(maxdist, sel)
    jtab = _seed_table(JMatchTable, *seeds)
    want = jgextend._extend_combine(
        case.jsq, JEvalues(1.0 / case.sigma), jtab, *fronts, *seeds,
        maxdist, case.least, qc, selfmode, allmax)
    ttab = _seed_table(MatchTable, *seeds)
    got = tgextend._extend_combine_device(
        case.tsq, Evalues(1.0 / case.sigma), lambda k: ttab.select(k[0]),
        *_device_args(case.tsq, seeds, fronts), maxdist, case.least, qc,
        selfmode, allmax, keys=_survivors(seeds))
    return got, want


@pytest.mark.parametrize("chunk", [1, 7, None],
                         ids=["chunk1", "chunk7", "one_chunk"])
@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("maxdist", [1, 2, 3])
def test_device_combination_equals_the_jax_package(cases, maxdist, mode,
                                                   allmax, chunk,
                                                   monkeypatch):
    """In chunks of 1 and 7 an even sample of 9 and 40 seeds; in one
    chunk all of them.  The rows must hold extensions that stop at a
    SEPARATOR or a text end."""
    case = cases[mode]
    S = case.seeds[0].size
    assert S > 100
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", chunk)
    sel = (np.arange(S) if chunk is None
           else np.unique(np.linspace(0, S - 1, 9 if chunk == 1 else 40
                                      ).astype(np.int64)))
    got, want = _both(case, maxdist, mode, allmax, sel)
    _assert_tables_equal(got, want)
    if chunk is not None:
        return
    assert len(want) > 10 and (want.length1 != want.length2).any()
    dists = set(want.distance.tolist())
    assert maxdist in dists and (allmax or len(dists) > 1)
    a, b = case.a, case.b
    ends1, ends2 = want.position1 + want.length1, want.position2 + want.length2
    at_edge = ((want.position1 == 0) | (ends1 == a.size)
               | (want.position2 == 0) | (ends2 == b.size))
    at_sep = ((a[np.maximum(want.position1 - 1, 0)] == SEPARATOR)
              | (a[np.minimum(ends1, a.size - 1)] == SEPARATOR)
              | (b[np.maximum(want.position2 - 1, 0)] == SEPARATOR)
              | (b[np.minimum(ends2, b.size - 1)] == SEPARATOR))
    assert at_edge.any() and at_sep.any()


def _stream(case, maxdist, monkeypatch):
    """The JAX package's -allmax emission stream over every seed, before
    the containers: (seed, combination, p1, p2, l1, l2, dist)."""
    seen = []
    monkeypatch.setattr(jgextend, "apply_allmax_containers",
                        lambda seeds, *cols: seen.append(cols[:7])
                        or JMatchTable())
    sel = np.arange(case.seeds[0].size)
    seeds, fronts = case.fronts(maxdist, sel)
    jgextend._extend_combine(
        case.jsq, JEvalues(1.0 / case.sigma),
        _seed_table(JMatchTable, *seeds), *fronts, *seeds, maxdist,
        case.least, False, True, True)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("maxdist", [2, 3])
def test_equal_evalues_fall_to_identity_and_length(cases, maxdist, allmax,
                                                   monkeypatch):
    """On the long copies a seed has accepted combinations of E-value 0
    at different lengths, of one distance and of several: the winner is
    decided by identity, then length, then the later combination."""
    case = cases["long"]
    sidx, _, _, _, l1, l2, dist = _stream(case, maxdist, monkeypatch)
    length = np.maximum(l1, l2)
    e = Evalues(0.25).get_batch(np.ones(dist.size), dist, length)
    zero = e == 0.0
    pairs = {(s, d) for s, d in zip(sidx[zero], dist[zero])}
    lengths = {}
    for s, d, ln in zip(sidx[zero], dist[zero], length[zero]):
        lengths.setdefault((s, d), set()).add(ln)
    assert any(len(v) > 1 for v in lengths.values())     # same dist
    assert len({s for s, _ in pairs}) < len(pairs)       # several dists
    got, want = _both(case, maxdist, "self", allmax,
                      np.arange(case.seeds[0].size))
    assert len(want) >= 3 and want.length1.max() > 600
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
def test_the_ports_numpy_copy_equals_the_device_function(cases, allmax):
    """The port keeps ``_extend_combine`` as the plain reference: on the
    same fronts it gives the device function's table."""
    case = cases["self"]
    sel = np.arange(case.seeds[0].size)
    seeds, fronts = case.fronts(2, sel)
    ttab = _seed_table(MatchTable, *seeds)
    want = tgextend._extend_combine(
        case.tsq, Evalues(0.25), ttab, *fronts, *seeds, 2, case.least,
        False, True, allmax)
    got = tgextend._extend_combine_device(
        case.tsq, Evalues(0.25), lambda k: ttab.select(k[0]),
        *_device_args(case.tsq, seeds, fronts), 2, case.least, False, True,
        allmax, keys=_survivors(seeds))
    assert len(want) > 10
    _assert_tables_equal(got, want)


def _synthetic_fronts(rng, S, maxdist, depth):
    """Fronts of S seeds with random entries below ``depth`` (a third
    undefined), level 0 only on the centre diagonal, and random usable
    depths; host int64 with the host's sentinel."""
    D = 2 * maxdist + 1
    out = []
    for _ in range(2):
        f = rng.integers(0, depth, (S, maxdist + 1, D))
        f[rng.random(f.shape) < 0.35] = jgextend.NEG
        f[:, 0, :] = jgextend.NEG
        f[:, 0, maxdist] = rng.integers(0, depth, S)
        out += [f, rng.integers(0, maxdist + 1, S)]
    return out


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("mode", ["self", "query"])
@pytest.mark.parametrize("maxdist", [1, 3])
def test_synthetic_fronts_cross_separators_and_text_ends(maxdist, mode,
                                                         allmax):
    """Fronts no extension would give: random entries over texts dense
    with separators, so that the extensions start or end on a SEPARATOR
    or outside a text on either side, and swap and acceptmatch meet
    every case (half the pairs a few chars apart); the device function
    equals the JAX package's ``_extend_combine``."""
    rng = np.random.default_rng(40 + maxdist)
    n, S = 600, 400
    a = rng.integers(0, 4, n).astype(np.uint8)
    a[rng.choice(n, 60, replace=False)] = SEPARATOR
    b = a if mode == "self" else rng.integers(0, 20, n + 77).astype(np.uint8)
    b[rng.choice(b.size, 50, replace=False)] = SEPARATOR
    pos1 = rng.integers(0, n, S)
    pos2 = rng.integers(0, b.size, S)
    # half the pairs a few chars apart: overlaps for acceptmatch
    pos2[::2] = np.minimum(pos1[::2] + rng.integers(0, 6, S // 2), n - 1)
    seeds = (pos1, pos2, rng.integers(1, 30, S))
    fronts = _synthetic_fronts(rng, S, maxdist, 40)
    qc, selfmode = MODES[mode]
    want = jgextend._extend_combine(
        jgextend.Seqs(a, b), JEvalues(0.25), _seed_table(JMatchTable, *seeds),
        *fronts, *seeds, maxdist, 20, qc, selfmode, allmax)
    tsq = tgextend.Seqs(a, b, "cpu")
    ttab = _seed_table(MatchTable, *seeds)
    got = tgextend._extend_combine_device(
        tsq, Evalues(0.25), lambda k: ttab.select(k[0]),
        *_device_args(tsq, seeds, fronts), maxdist, 20, qc, selfmode, allmax,
        keys=_survivors(seeds))
    assert len(want) > 100
    _assert_tables_equal(got, want)


def test_identity_in_float64_decides_e_value_ties():
    """Two extensions of one seed with E-value 0 (past the table's rows):
    1718 chars at distance 1 and 5153 at distance 3.  Their identities
    differ in float64 (the shorter one wins) and collapse in float32
    (the longer one would win by length)."""
    la, lb = 1718, 3 * 1718 - 1
    assert np.float32(100) * (1 - np.float32(1) / np.float32(la)) == (
        np.float32(100) * (1 - np.float32(3) / np.float32(lb)))
    text = np.zeros(8000, np.uint8)
    other = np.ones(8000, np.uint8)
    seeds = tuple(np.array([v], np.int64) for v in (1000, 1200, 100))
    lf = np.full((1, 4, 7), jgextend.NEG)
    rf = lf.copy()
    lf[0, 0, 3] = rf[0, 0, 3] = 0
    rf[0, 1, 3], rf[0, 3, 3] = la - 100, lb - 100
    fronts = (lf, np.zeros(1, np.int64), rf, np.full(1, 3))
    want = jgextend._extend_combine(
        jgextend.Seqs(text, other), JEvalues(0.25),
        _seed_table(JMatchTable, *seeds), *fronts, *seeds, 3, 20, True,
        False, False)
    assert want.length1.tolist() == [la] and want.distance.tolist() == [1]
    tsq = tgextend.Seqs(text, other, "cpu")
    ttab = _seed_table(MatchTable, *seeds)
    _assert_tables_equal(tgextend._extend_combine_device(
        tsq, Evalues(0.25), lambda k: ttab.select(k[0]),
        *_device_args(tsq, seeds, fronts), 3, 20, True, False, False,
        keys=_survivors(seeds)), want)


def test_no_survivor_and_no_winner(cases):
    """Without a survivor, and with survivors of which none is
    accepted, the device function returns an empty table."""
    case = cases["self"]
    seeds, fronts = case.fronts(2, np.arange(5))
    args = _device_args(case.tsq, seeds, fronts)
    for allmax in (False, True):
        assert len(tgextend._extend_combine_device(
            case.tsq, Evalues(0.25), None, *args, 2, 10_000, False, True,
            allmax, keys=_survivors(seeds))) == 0
    assert tgextend_dev.edit_fronts_viable_device(
        case.tsq, *seeds, 2, 10_000, case.L)[0].numel() == 0


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def cli_index(tmp_path_factory):
    """Three DNA records with edited copies, indexed by the port's
    mkvtree, and a query file of edited pieces of them."""
    tmp = tmp_path_factory.mktemp("torchcombine")
    letters = np.frombuffer(b"acgtn|", np.uint8)
    text = _repeat_text(11, 4200, inverted=True)
    chars = np.where(text < 4, text, np.where(text == WILDCARD, 4, 5))
    recs = letters[chars].tobytes().decode().split("|")
    rng = np.random.default_rng(12)
    query = text[rng.integers(0, 1800):][:1500].copy()
    query[rng.choice(query.size, 12, replace=False)] = rng.integers(0, 4, 12)
    query[query > 3] = 0
    q = letters[query].tobytes().decode()
    db = _fasta(tmp / "x.fna", recs)
    qf = _fasta(tmp / "q.fna", [q[:700], q[700:]])
    index = str(tmp / "torch_x")
    assert tmkvtree.run(["-db", db, "-dna", "-pl", "-allout",
                         "-indexname", index], "cpu") == 0
    return index, qf


@pytest.mark.parametrize("task", [
    ["-l", "24", "-e", "2"],
    ["-l", "24", "-e", "2", "-allmax"],
    ["-l", "24", "-e", "2", "-q", "{q}"],
    ["-l", "24", "-e", "2", "-p"],
], ids=["self", "allmax", "q", "p"])
def test_cli_never_reaches_the_numpy_combination(cli_index, task,
                                                 monkeypatch):
    """``vmatch -l 24 -e 2`` on the port's CLI with the NumPy
    combination and the fronts' download made to raise: the same bytes
    as the JAX CLI, so the main path reaches neither."""
    index, qf = cli_index
    argv = [qf if a == "{q}" else a for a in task] + [index]
    want = io.StringIO()
    with monkeypatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        mp.delenv("VSTREE_DEVICE_ENGINES", raising=False)
        assert jvmatch.run(argv, out=want) == 0

    def refuse(*args, **kw):
        raise AssertionError("the main path reached a host copy")

    calls = []
    real = tgextend_dev.combine_fronts
    monkeypatch.setattr(tgextend, "_extend_combine", refuse)
    monkeypatch.setattr(tgextend_dev, "edit_fronts_viable", refuse)
    monkeypatch.setattr(tgextend, "combine_fronts",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = io.StringIO()
    assert tvmatch.run(argv, "cpu", out=got) == 0
    assert got.getvalue() == want.getvalue()
    assert calls and len(want.getvalue().splitlines()) > 5
