"""Port vs JAX package: the block-streamed index reader
(``index/stream.py``, the reference's esastream) and the Karlin-Altschul
parameters (``stats/karlin.py``), both copies.

The index is written by the port's ``mkvtree`` to ``tmp_path``: 60 kbp
in five records with planted copies of 300-600 bp, so that lcp values
above 254 go through the ``.llv`` exceptions.  At block sizes 977, 8192
and above n the port's ``stream_l_runs`` and
``stream_supermax_intervals`` give the JAX package's runs and intervals
and the in-memory engines' ones.
"""

import math

import numpy as np
import pytest

from vstree_tpu.index import stream as jstream
from vstree_tpu.stats import karlin as jkarlin
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.engine.repeats import _l_runs
from vstree_tpu_torch.engine.supermax import supermax_intervals
from vstree_tpu_torch.index import stream as tstream
from vstree_tpu_torch.index.io import read_index
from vstree_tpu_torch.stats import karlin as tkarlin

BLOCKS = [977, 8192, 1 << 20]


@pytest.fixture(scope="module")
def idx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tstream")
    rng = np.random.default_rng(31)
    recs = []
    for _ in range(5):
        r = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, 12_000)]
        r[rng.integers(0, 12_000, 4)] = ord("n")
        recs.append(r)
    for _ in range(12):                  # planted copies of 300-600 bp
        a, b = rng.integers(0, 5, 2)
        ln = int(rng.integers(300, 600))
        sa, sb = rng.integers(0, 12_000 - ln, 2)
        recs[b][sb:sb + ln] = recs[a][sa:sa + ln]
    fa = tmp / "db.fna"
    with open(fa, "wb") as fh:
        for i, r in enumerate(recs):
            fh.write(b">r%d\n" % i + r.tobytes() + b"\n")
    name = str(tmp / "idx")
    assert tmkvtree.run(["-db", str(fa), "-dna", "-pl", "-allout",
                         "-indexname", name], "cpu") == 0
    esa = read_index(name, demand=("suf", "lcp", "bwt"))
    assert esa.lcptab.max() > 254       # the llv path is taken
    return name, esa


@pytest.mark.parametrize("bs", BLOCKS)
def test_stream_blocks_same_as_jax(idx, bs):
    name, esa = idx
    with jstream.ESAStream(name, blocksize=bs) as js, \
            tstream.ESAStream(name, blocksize=bs) as ts:
        want, got = list(js.blocks()), list(ts.blocks())
    assert len(got) == len(want) == -(-esa.suftab.size // bs)
    for w, g in zip(want, got):
        assert g[0] == w[0]
        for a, b in zip(w[1:], g[1:]):
            np.testing.assert_array_equal(b, a)
            assert b.size <= bs
    np.testing.assert_array_equal(np.concatenate([g[2] for g in got]),
                                  esa.lcptab)


@pytest.mark.parametrize("bs", BLOCKS)
def test_stream_l_runs_same_as_jax(idx, bs):
    name, esa = idx
    for L in (8, 20, 300):
        with jstream.ESAStream(name, blocksize=bs) as js:
            want = list(jstream.stream_l_runs(js, L))
        with tstream.ESAStream(name, blocksize=bs) as ts:
            got = list(tstream.stream_l_runs(ts, L))
        assert got == want
        mem = list(zip(*_l_runs(esa.lcptab, L)))
        assert got == [(int(a), int(b)) for a, b in mem]
        assert got or L == 300


@pytest.mark.parametrize("bs", BLOCKS)
def test_stream_supermax_same_as_jax(idx, bs):
    name, esa = idx
    for L in (12, 20, 30):
        with jstream.ESAStream(name, blocksize=bs) as js:
            want = list(jstream.stream_supermax_intervals(js, L, 4))
        with tstream.ESAStream(name, blocksize=bs) as ts:
            got = list(tstream.stream_supermax_intervals(ts, L, 4))
        assert got == want
        wl, wr, wd = supermax_intervals(esa, L)
        assert got == list(zip(wl.tolist(), wr.tolist(), wd.tolist()))
        assert got


GOLDEN_ARGS = [
    (-1, 2, [0.75, 0.0, 0.0, 0.25]),
    (-2, 2, [0.4, 0.3, 0.0, 0.1, 0.2]),
    (-3, 2, [0.5, 0.0, 0.2, 0.0, 0.0, 0.3]),
    (-2, 1, [0.6, 0.1, 0.05, 0.25]),
]


@pytest.mark.parametrize("args", GOLDEN_ARGS)
def test_karlinpp_same_as_jax(args):
    assert tkarlin.karlinpp(*args) == jkarlin.karlinpp(*args)


def test_unitcost_and_significance_same_as_jax():
    lam, K = tkarlin.karlinunitcostpp()
    assert (lam, K) == jkarlin.karlinunitcostpp()
    assert math.isclose(lam, 0.264497071504593, rel_tol=1e-13)
    for mult, score in ((1000.0, 40), (1e6, 20), (3.5, 7)):
        assert (tkarlin.significance(lam, K, mult, score)
                == jkarlin.significance(lam, K, mult, score))


@pytest.mark.parametrize("args", [
    (0, 2, [0.5, 0.25, 0.25]),
    (-2, 2, [0.2, 0.3, 0.0, 0.1, 0.4]),
])
def test_karlinpp_refuses_alike(args):
    msgs = []
    for mod in (jkarlin, tkarlin):
        with pytest.raises(ValueError) as e:
            mod.karlinpp(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
