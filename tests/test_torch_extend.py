"""Port vs JAX package: seed extension (``engine/gextend.py``,
``engine/gextend_dev.py``, ``engine/xdrop.py``): the Hamming look
tables, the edit fronts and their viability filter, the best and the
``-allmax`` extensions per seed, and the x-drop extensions.

The same NumPy texts and seeds go through both packages; fronts, ``h``,
viable sets and every ``MatchTable`` column must be equal (integers
equal, E-values bit-equal; tolerance 0).  The port's fronts run on CPU
tensors, at one chunk and at a forced small chunk; the JAX package's run
on the host (``edit_fronts``, the oracle) and, with
``VSTREE_DEVICE_ENGINES=1``, as its device programs on the CPU backend,
fused (no sync) and host-looped (synced).
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import gextend as jgextend
from vstree_tpu.engine import gextend_dev as jgextend_dev
from vstree_tpu.engine import repeats as jrepeats
from vstree_tpu.engine import xdrop as jxdrop
from vstree_tpu.engine.match import MatchTable as JMatchTable
from vstree_tpu.index.build import build_esa
from vstree_tpu.stats.evalues import Evalues as JEvalues
from vstree_tpu_torch.engine import gextend as tgextend
from vstree_tpu_torch.engine import gextend_dev as tgextend_dev
from vstree_tpu_torch.engine import xdrop as txdrop
from vstree_tpu_torch.engine.match import MatchTable
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.stats.evalues import Evalues

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")
WILDCARD, SEPARATOR = 254, 255


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops launch thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
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


def _text(sigma: int, n: int, seed: int) -> np.ndarray:
    """Several records of repeat-rich text: copies of three elements that
    differ by substitutions and indels, two tandem arrays (one with a
    mutated unit), runs of wildcards, a copy at either end of the text
    and one beside a separator."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    elems = [rng.integers(0, sigma, ln).astype(np.uint8)
             for ln in (70, 110, 160)]
    at = 40
    for k in range(15):
        copy = _mutated(rng, elems[k % 3], sigma, k % 3, k % 2)
        at += int(rng.integers(20, 120))
        text[at:at + copy.size] = copy
        at += copy.size
    assert at < n - 400
    unit = rng.integers(0, sigma, 9).astype(np.uint8)
    text[at + 20:at + 20 + 90] = np.tile(unit, 10)
    arr = np.tile(rng.integers(0, sigma, 13).astype(np.uint8), 8)
    arr[50] = (arr[50] + 1) % sigma
    text[at + 150:at + 150 + arr.size] = arr
    text[:60] = elems[0][:60]
    text[n - 80:] = elems[1][:80]
    for st in rng.choice(n - 10, 4, replace=False):
        text[st:st + int(rng.integers(1, 5))] = WILDCARD
    seps = np.sort(rng.choice(np.arange(300, n - 300), 3, replace=False))
    text[seps] = SEPARATOR
    text[seps[0] + 1:seps[0] + 1 + 50] = elems[2][:50]
    text[seps[1] - 45:seps[1]] = elems[2][60:105]
    return text


def _index(text, alpha):
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    jesa = build_esa(ms, alpha, demand=("suf", "lcp", "bwt", "bck", "sti"))
    return jesa, ESA.from_shared(jesa, "cpu")


class Case:
    """One text through both packages: indexes, Seqs objects, E-values
    and the maximal pairs of length >= L as seeds."""

    def __init__(self, sigma, n, seed, alpha, L):
        self.sigma, self.L = sigma, L
        self.text = _text(sigma, n, seed)
        self.jesa, self.tesa = _index(self.text, alpha)
        self.jsq = jgextend.Seqs(self.text, self.text)
        self.tsq = tgextend.Seqs(self.text, self.text, "cpu")
        self.jev, self.tev = JEvalues(1.0 / sigma), Evalues(1.0 / sigma)
        self.jseeds = jrepeats.find_maximal_pairs_ref_sim(self.jesa, L)
        self.tseeds = MatchTable(**{f: getattr(self.jseeds, f).copy()
                                    for f in FIELDS})
        self.pos1 = self.jseeds.position1.astype(np.int64)
        self.pos2 = self.jseeds.position2.astype(np.int64)
        self.slen = self.jseeds.length1.astype(np.int64)


@pytest.fixture(scope="module")
def dna():
    case = Case(4, 5000, 61, dna_alphabet(), 6)
    assert len(case.jseeds) > 800
    return case


@pytest.fixture(scope="module")
def protein():
    case = Case(20, 4000, 62, protein_alphabet(), 4)
    assert len(case.jseeds) > 150
    return case


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("maxdist", [0, 1, 3])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_hamming_look_tables(kind, maxdist, request):
    c = request.getfixturevalue(kind)
    for got, want in (
            (tgextend.hamming_look_left(c.tsq, c.pos1, c.pos2, maxdist, c.L),
             jgextend.hamming_look_left(c.jsq, c.pos1, c.pos2, maxdist, c.L)),
            (tgextend.hamming_look_right(c.tsq, c.pos1 + c.slen,
                                         c.pos2 + c.slen, maxdist),
             jgextend.hamming_look_right(c.jsq, c.pos1 + c.slen,
                                         c.pos2 + c.slen, maxdist))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert maxdist == 0 or got[0].max() >= 10


def _host_fronts(c, maxdist, sq=None, pos=None, reach=None):
    """The JAX package's host fronts (both directions) of all seeds."""
    sq = sq or c.jsq
    p1, p2, sl = pos or (c.pos1, c.pos2, c.slen)
    lf, hl = jgextend.edit_fronts(sq, p1 - 1, p2 - 1, p1, p2, maxdist,
                                  forward=False,
                                  reachlength=c.L if reach is None else reach)
    rf, hr = jgextend.edit_fronts(sq, p1 + sl, p2 + sl, sq.n1 - (p1 + sl),
                                  sq.n2 - (p2 + sl), maxdist, forward=True,
                                  reachlength=None)
    return lf, hl, rf, hr


@pytest.mark.parametrize("chunk", [None, 61], ids=["one_chunk", "chunk61"])
@pytest.mark.parametrize("maxdist", [1, 2, 3])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_edit_fronts_equal_the_host_fronts(kind, maxdist, chunk, request,
                                           monkeypatch):
    """leastlength 0 keeps every seed, so the port's fronts and ``h`` of
    all seeds stand against ``edit_fronts``; the sentinel is the
    host's."""
    c = request.getfixturevalue(kind)
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", chunk)
    seen = []
    real = tgextend_dev._fronts_direction
    monkeypatch.setattr(tgextend_dev, "_fronts_direction",
                        lambda *a, **k: seen.append(a[2].numel())
                        or real(*a, **k))
    vidx, lf, hl, rf, hr = tgextend_dev.edit_fronts_viable(
        c.tsq, c.pos1, c.pos2, c.slen, maxdist, 0, c.L)
    S = c.pos1.size
    assert len(seen) == (2 if chunk is None else 2 * -(-S // chunk))
    np.testing.assert_array_equal(vidx, np.arange(S))
    for g, w in zip((lf, hl, rf, hr), _host_fronts(c, maxdist)):
        assert g.dtype == w.dtype == np.int64 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert lf.min() == jgextend.NEG and rf.max() >= 20
    assert (hl == maxdist).any() and (maxdist == 1 or (hl < maxdist).any())


@pytest.mark.parametrize("nosync", [True, False], ids=["nosync", "synced"])
@pytest.mark.parametrize("forward", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_fronts_direction_equals_the_jax_device_program(kind, forward, nosync,
                                                        request):
    """One direction against the JAX package's device program on the CPU
    backend, fused (one dispatch, no sync) and host-looped: the same
    int32 fronts, device sentinel included, and the same ``h``."""
    import jax.numpy as jnp

    c = request.getfixturevalue(kind)
    maxdist = 2
    n = c.text.size
    if forward:
        args = (c.pos1 + c.slen, c.pos2 + c.slen, n - (c.pos1 + c.slen),
                n - (c.pos2 + c.slen))
        reach = 0
    else:
        args = (c.pos1 - 1, c.pos2 - 1, c.pos1, c.pos2)
        reach = c.L
    jf, jh, oflow = jgextend_dev._fronts_direction(
        c.jsq, jgextend_dev._dev_tables(c.jsq),
        *(jnp.asarray(a, jnp.int32) for a in args), maxdist,
        forward=forward, reach=reach, nosync=nosync)
    assert int(oflow) == 0
    tf, th = tgextend_dev._fronts_direction(
        c.tsq, tgextend_dev._dev_tables(c.tsq),
        *(torch.from_numpy(a) for a in args), maxdist, forward=forward,
        reach=reach)
    assert tf.dtype == torch.int32 and th.dtype == torch.int64
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(tf.min()) == tgextend_dev.NEG32 == int(jgextend_dev.NEG32)


@pytest.mark.parametrize("chunk", [None, 97], ids=["one_chunk", "chunk97"])
@pytest.mark.parametrize("least", [14, 22])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_viable_set_equals_both_jax_routes(kind, least, chunk, request,
                                           monkeypatch):
    """The viability filter: the survivors and their fronts equal the
    JAX package's ``edit_fronts_viable`` (device engines switched on by
    the environment) and a filter of the host fronts."""
    c = request.getfixturevalue(kind)
    maxdist = 2
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", chunk)
    got = tgextend_dev.edit_fronts_viable(c.tsq, c.pos1, c.pos2, c.slen,
                                          maxdist, least, c.L)
    monkeypatch.setenv("VSTREE_DEVICE_ENGINES", "1")
    want = jgextend_dev.edit_fronts_viable(c.jsq, c.pos1, c.pos2, c.slen,
                                           maxdist, least, c.L)
    assert 0 < got[0].size < c.pos1.size
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    host = _host_fronts(c, maxdist)
    for g, w in zip(got[1:], host):
        np.testing.assert_array_equal(g, w[got[0]])
    # seeds as tensors on the device give the same (the fused path)
    dev = tgextend_dev.edit_fronts_viable(
        c.tsq, *(torch.from_numpy(a) for a in (c.pos1, c.pos2, c.slen)),
        maxdist, least, c.L)
    for g, w in zip(dev, got):
        np.testing.assert_array_equal(g, w)
    none = tgextend_dev.edit_fronts_viable(c.tsq, c.pos1, c.pos2, c.slen,
                                           maxdist, 5000, c.L)
    assert none[0].size == 0 and none[1] is None and none[3] is None


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("maxdist", [1, 2])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_hamming_extend_seeds(kind, maxdist, allmax, request):
    c = request.getfixturevalue(kind)
    least = 16 if kind == "dna" else 10
    want = jgextend.hamming_extend_seeds(c.jsq, c.jev, c.jseeds, maxdist,
                                         least, c.L, False, allmax)
    got = tgextend.hamming_extend_seeds(c.tsq, c.tev, c.tseeds, maxdist,
                                        least, c.L, False, allmax)
    assert len(want) > 20
    _assert_tables_equal(got, want)
    assert len(tgextend.hamming_extend_seeds(
        c.tsq, c.tev, MatchTable(), maxdist, least, c.L, False)) == 0


@pytest.mark.parametrize("chunk", [None, 97], ids=["one_chunk", "chunk97"])
@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("maxdist", [1, 2])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_edit_extend_seeds(kind, maxdist, allmax, chunk, request,
                           monkeypatch):
    """The two-step path against the JAX package's host path (the oracle
    ``edit_fronts`` underneath)."""
    c = request.getfixturevalue(kind)
    least = 16 if kind == "dna" else 10
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", chunk)
    monkeypatch.delenv("VSTREE_DEVICE_ENGINES", raising=False)
    want = jgextend.edit_extend_seeds(c.jsq, c.jev, c.jseeds, maxdist, least,
                                      c.L, False, True, allmax)
    got = tgextend.edit_extend_seeds(c.tsq, c.tev, c.tseeds, maxdist, least,
                                     c.L, False, True, allmax)
    assert len(want) > 20 and (want.length1 != want.length2).any()
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
@pytest.mark.parametrize("maxdist", [1, 2])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_edit_extend_self_device(kind, maxdist, allmax, request, monkeypatch):
    """The fused path (seeds stay on the device, survivors take the
    reference's emission order) against the JAX package's fused path and
    against its two-step host path; at a small chunk too."""
    c = request.getfixturevalue(kind)
    least = 16 if kind == "dna" else 10
    monkeypatch.setenv("VSTREE_DEVICE_ENGINES", "1")
    want = jgextend.edit_extend_self_device(c.jesa, c.jsq, c.jev, maxdist,
                                            least, c.L, allmax)
    monkeypatch.delenv("VSTREE_DEVICE_ENGINES")
    assert jgextend.edit_extend_self_device(
        c.jesa, c.jsq, c.jev, maxdist, least, c.L, allmax) is None
    host = jgextend.edit_extend_seeds(c.jsq, c.jev, c.jseeds, maxdist, least,
                                      c.L, False, True, allmax)
    for chunk in (None, 53):
        monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", chunk)
        got = tgextend.edit_extend_self_device(c.tesa, c.tsq, c.tev, maxdist,
                                               least, c.L, allmax)
        assert len(got) > 20
        _assert_tables_equal(got, want)
        _assert_tables_equal(got, host)
    assert len(tgextend.edit_extend_self_device(
        c.tesa, c.tsq, c.tev, maxdist, 4000, 3000)) == 0
    assert len(tgextend.edit_extend_self_device(
        c.tesa, c.tsq, c.tev, maxdist, 4000, c.L)) == 0


def test_fused_path_gives_way_on_the_pathological_run_guard(dna,
                                                            monkeypatch):
    from vstree_tpu_torch.engine import repeats_dev

    monkeypatch.setattr(repeats_dev, "_PAIR_CHUNK", 2)
    assert tgextend.edit_extend_self_device(
        dna.tesa, dna.tsq, dna.tev, 1, 16, dna.L) is None


def _two_texts(sigma, seed):
    """A second text made of edited pieces of the first, and the exact
    stretches the two share as seeds (position in text 1, in text 2,
    length)."""
    rng = np.random.default_rng(seed)
    a = _text(sigma, 4000, seed)
    b = rng.integers(0, sigma, 1500).astype(np.uint8)
    seeds = []
    at = 0
    for k in range(12):
        src = int(rng.integers(0, a.size - 130))
        ln = int(rng.integers(40, 120))
        piece = a[src:src + ln].copy()
        cut = ln // 2
        piece[cut] = (piece[cut] + 1) % sigma if piece[cut] < sigma else 0
        if k % 3 == 0:
            piece = np.delete(piece, cut + 5)
        b[at:at + piece.size] = piece
        if (a[src:src + cut] < WILDCARD).all() and cut >= 12:
            seeds.append((src, at, cut))
        at += piece.size + int(rng.integers(0, 6))
    b[at:] = a[a.size - (b.size - at):]     # the texts' ends match
    seeds.append((a.size - 30, b.size - 30, 30))
    b[[400, 900]] = SEPARATOR
    p1, p2, sl = (np.array(col, np.int64) for col in zip(*seeds))
    ok = np.array([(a[x:x + n] == b[y:y + n]).all()
                   and (b[y:y + n] < WILDCARD).all()
                   for x, y, n in zip(p1, p2, sl)])
    return a, b, (p1[ok], p2[ok], sl[ok])


def _seed_table(cls, p1, p2, sl):
    tot = p1.size
    z = np.zeros(tot, np.int64)
    return cls(length1=sl.copy(), position1=p1.copy(), length2=sl.copy(),
               position2=p2.copy(), distance=z.copy(), flag=z + 1,
               seqnum1=z.copy(), relpos1=p1.copy(), seqnum2=z.copy(),
               relpos2=p2.copy(), evalue=np.zeros(tot, np.float64),
               idnumber=z.copy(), transnum=z - 1)


@pytest.mark.parametrize("sigma", [4, 20], ids=["dna", "protein"])
def test_two_text_extension(sigma, monkeypatch):
    """A database text against a query text (``s2 is not s1``: no
    same-pointer shortcut, ``querycompare`` shifts relpos2): fronts,
    Hamming, edit and x-drop extensions of known seeds."""
    a, b, (p1, p2, sl) = _two_texts(sigma, 70 + sigma)
    assert p1.size >= 6
    jsq, tsq = jgextend.Seqs(a, b), tgextend.Seqs(a, b, "cpu")
    jev, tev = JEvalues(1.0 / sigma), Evalues(1.0 / sigma)
    jseeds = _seed_table(JMatchTable, p1, p2, sl)
    tseeds = _seed_table(MatchTable, p1, p2, sl)

    class c:
        L = 12
    got = tgextend_dev.edit_fronts_viable(tsq, p1, p2, sl, 2, 0, 12)
    for g, w in zip(got[1:], _host_fronts(c, 2, jsq, (p1, p2, sl))):
        np.testing.assert_array_equal(g, w)
    monkeypatch.delenv("VSTREE_DEVICE_ENGINES", raising=False)
    for allmax in (False, True):
        want = jgextend.edit_extend_seeds(jsq, jev, jseeds, 2, 30, 12, True,
                                          False, allmax)
        assert len(want) >= 4
        _assert_tables_equal(tgextend.edit_extend_seeds(
            tsq, tev, tseeds, 2, 30, 12, True, False, allmax), want)
        want = jgextend.hamming_extend_seeds(jsq, jev, jseeds, 2, 30, 12,
                                             True, allmax)
        assert len(want) >= 4
        _assert_tables_equal(tgextend.hamming_extend_seeds(
            tsq, tev, tseeds, 2, 30, 12, True, allmax), want)
    for x in (4, -4):
        want = jxdrop.xdrop_extend_seeds(jsq, jseeds, x, 12, True)
        assert len(want) >= 4
        _assert_tables_equal(
            txdrop.xdrop_extend_seeds(tsq, tseeds, x, 12, True), want)


@pytest.mark.parametrize("forward", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("X", [1, 2, 3])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_xdrop_batches(kind, X, forward, request):
    """``edit_xdrop_batch`` and ``hamming_xdrop_batch`` on the seeds'
    flanks, as ``xdrop_extend_seeds`` calls them (every third seed: the
    original keeps all seeds at the window of its longest-running one)."""
    c = request.getfixturevalue(kind)
    n = c.text.size
    pos1, pos2, slen = c.pos1[::3], c.pos2[::3], c.slen[::3]
    if forward:
        jt, jd = (c.jsq.s1, c.jsq.s2), (c.jsq.d_s1, c.jsq.d_s2)
        args = (pos1 + slen, pos2 + slen, n - (pos1 + slen),
                n - (pos2 + slen))
    else:
        jt, jd = (c.jsq.r1, c.jsq.r2), (c.jsq.d_r1, c.jsq.d_r2)
        args = (n - pos1, n - pos2, pos1, pos2)
    want = jxdrop.edit_xdrop_batch(*jt, *args, X, tu_dev=jd[0], tv_dev=jd[1])
    got = txdrop.edit_xdrop_batch(c.tsq, forward, *args, X)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].max() >= 20 and (X == 1 or (got[0] != got[1]).any())
    for reach in (None, c.L):
        want = jxdrop.hamming_xdrop_batch(*jt, *args, X, reachlength=reach,
                                          tu_dev=jd[0], tv_dev=jd[1])
        got = txdrop.hamming_xdrop_batch(c.tsq, forward, *args, X,
                                         reachlength=reach)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[2].any() == (reach is not None)
    empty = np.zeros(0, np.int64)
    assert txdrop.edit_xdrop_batch(c.tsq, forward, *[empty] * 4, X)[0].size == 0


def test_edit_xdrop_state_follows_the_live_seeds(dna, monkeypatch):
    """The state drops finished seeds, its diagonals are the window of
    the live bands and its score table grows with the generations; none
    of it changes a result (the original keeps every seed at a window of
    129 diagonals and more).  The widths are counted on the way."""
    c = dna
    n = c.text.size
    pos1, pos2, slen = c.pos1[1::3], c.pos2[1::3], c.slen[1::3]
    args = (pos1 + slen, pos2 + slen, n - (pos1 + slen), n - (pos2 + slen))
    want = jxdrop.edit_xdrop_batch(c.jsq.s1, c.jsq.s2, *args, 4)
    shapes = []
    real = txdrop._slide
    monkeypatch.setattr(txdrop, "_slide", lambda *a: shapes.append(a[2].size)
                        or real(*a))
    for cap in (1, 4096):
        monkeypatch.setattr(txdrop, "_XDROP_CAP", cap)
        for g, w in zip(txdrop.edit_xdrop_batch(c.tsq, True, *args, 4), want):
            np.testing.assert_array_equal(g, w)
    assert len(shapes) > 40 and min(shapes) < pos1.size // 10


@pytest.mark.parametrize("x", [3, -3, 2, -1])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_xdrop_extend_seeds(kind, x, request):
    c = request.getfixturevalue(kind)
    want = jxdrop.xdrop_extend_seeds(c.jsq, c.jseeds, x, c.L, False)
    got = txdrop.xdrop_extend_seeds(c.tsq, c.tseeds, x, c.L, False)
    assert len(want) > 50
    _assert_tables_equal(got, want)
    assert len(txdrop.xdrop_extend_seeds(c.tsq, MatchTable(), x, c.L,
                                         False)) == 0


def test_sep_tables_and_distances():
    """prev/next separator tables (cummax; cummin of the flipped text)
    and the distances read from them, against the host functions."""
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 400).astype(np.uint8)
    text[[0, 57, 58, 200, 399]] = SEPARATOR
    t = torch.from_numpy(text)
    prev = tgextend_dev._prevsep_table(t, 400)
    nxt = tgextend_dev._nextsep_table(t, 400)
    assert prev.dtype == nxt.dtype == torch.int32
    start = np.concatenate([np.arange(-1, 402), [0, 400]])
    np.testing.assert_array_equal(
        tgextend_dev._sep_left(prev, torch.from_numpy(start), 400).numpy(),
        jgextend._sep_dist_left(text, start))
    np.testing.assert_array_equal(
        tgextend_dev._sep_right(nxt, torch.from_numpy(start[1:]), 400
                                ).numpy(),
        jgextend._sep_dist_right(text, start[1:]))
    none = torch.zeros(50, dtype=torch.uint8)
    assert tgextend_dev._prevsep_table(none, 50).tolist() == [-1] * 50
    assert tgextend_dev._nextsep_table(none, 50).tolist() == [100] * 50


def test_chunk_size_comes_from_the_module_or_the_device(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", None)
    assert tgextend_dev._chunk_seeds(cpu, 2) == 1 << 20
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", 7)
    assert tgextend_dev._chunk_seeds(cpu, 2) == 7
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", None)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (60 << 30, 80 << 30))
    many = tgextend_dev._chunk_seeds(torch.device("cuda", 0), 2)
    few = tgextend_dev._chunk_seeds(torch.device("cuda", 0), 6)
    assert (1 << 16) <= few < many <= (1 << 23)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (1 << 20, 80 << 30))
    assert tgextend_dev._chunk_seeds(torch.device("cuda", 0), 2) == 1 << 16
