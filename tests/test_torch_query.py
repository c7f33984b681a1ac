"""The port's query matching on the index (``vstree_tpu_torch/engine/
query.py``, ``querydev.py``) against the JAX package, on the CPU.

Tables are compared column by column and IN ORDER: the emission order
rests on the reference's witness (``_ref_witness_state``), so equal rows
in another order would be a fault.  The oracles are the JAX package's
default path and its host path (``VSTREE_HOST_QUERY=1``).  Where the JAX
package's fault F3 bites (the db-vs-itself pipeline's second ladder rung
reuses the overflowing scan budget), the port must give up at once and
still equal the host path (``tests/test_torch_query_self.py``, with the
merged-sort path: the file is split to keep each under ~3 minutes on one
worker).
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet as j_dna
from vstree_tpu.core.alphabet import protein_alphabet as j_protein
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.engine import query as jquery
from vstree_tpu.engine import querydev as jquerydev
from vstree_tpu.index.build import bucket_codes
from vstree_tpu.index.build import build_esa as j_build_esa
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.device import PhaseTimes, record_phases
from vstree_tpu_torch.engine import query as tquery
from vstree_tpu_torch.engine import querydev as tquerydev
from vstree_tpu_torch.engine import repeats_dev
from vstree_tpu_torch.index.esa import ESA

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue many small ops; a thread pool per test
    worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _multiseq(cls, text):
    ms = cls(sequence=text.copy(), totallength=int(text.size))
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    ms.descriptions = [b"s%d" % i for i in range(ms.numofsequences)]
    return ms


def _db(rng, kind):
    """A database text of several records: random, with planted copies
    of blocks, a duplicated record (suffixes equal up to the separator,
    so the db-vs-itself pipeline has replay lanes), N runs."""
    sigma = 20 if kind == "protein" else 4
    recs = [rng.integers(0, sigma, int(rng.integers(900, 1800))).astype(
        np.uint8) for _ in range(5)]
    for _ in range(8):
        a, b = rng.choice(len(recs), 2, replace=False)
        ln = int(rng.integers(40, 200))
        src = int(rng.integers(0, recs[a].size - ln))
        dst = int(rng.integers(0, recs[b].size - ln))
        recs[b][dst:dst + ln] = recs[a][src:src + ln]
    for r in recs[2:4]:
        st = int(rng.integers(0, r.size - 30))
        r[st:st + int(rng.integers(3, 20))] = 254       # an N run
    recs.append(recs[1].copy())                         # a duplicate
    text = np.concatenate([np.append(r, 255) for r in recs])[:-1]
    return text, sigma


def _query_text(rng, text, sigma, nrec=4):
    """Query records made of mutated windows of the db, random filler
    and wildcards."""
    recs = []
    for _ in range(nrec):
        parts = []
        for _ in range(3):
            ln = int(rng.integers(60, 400))
            st = int(rng.integers(0, text.size - ln))
            w = text[st:st + ln].copy()
            w = np.where(w == 255, 254, w).astype(np.uint8)
            mut = rng.choice(ln, max(1, ln // 60), replace=False)
            w[mut] = rng.integers(0, sigma, mut.size)
            parts += [w, rng.integers(0, sigma, int(rng.integers(5, 60)))]
        r = np.concatenate(parts).astype(np.uint8)
        r[rng.choice(r.size, 2, replace=False)] = 254
        recs.append(r)
    return np.concatenate([np.append(r, 255) for r in recs])[:-1]


@pytest.fixture(scope="module", params=["dna", "protein"])
def case(request):
    rng = np.random.default_rng({"dna": 61, "protein": 62}[request.param])
    text, sigma = _db(rng, request.param)
    alpha = j_protein() if request.param == "protein" else j_dna()
    jesa = j_build_esa(_multiseq(JMultiseq, text), alpha,
                       demand=("suf", "lcp", "bwt", "bck", "sti"))
    q = _query_text(rng, text, sigma)
    return {"jesa": jesa, "tesa": ESA.from_shared(jesa, "cpu"), "q": q,
            "text": text, "sigma": sigma, "kind": request.param}


def _equal(got, want, tag=""):
    assert len(got) == len(want), (tag, len(got), len(want))
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, (tag, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{tag} {f}")


def _jax_both(jesa, query, L, mode, qsp, monkeypatch, flags=0):
    """The JAX package's default path and its host path."""
    want = jquery.find_query_matches(jesa, query, L, mode,
                                     flags_extra=flags, qspeedup=qsp)
    with monkeypatch.context() as mp:
        mp.setenv("VSTREE_HOST_QUERY", "1")
        host = jquery.find_query_matches(jesa, query, L, mode,
                                         flags_extra=flags, qspeedup=qsp)
    return want, host


@pytest.mark.parametrize("qsp", [0, 2, 5])
@pytest.mark.parametrize("mode", ["mem", "mumcand", "mum"])
def test_find_query_matches_equal_the_jax_package(case, mode, qsp,
                                                  monkeypatch):
    L = 8 if case["kind"] == "protein" else 14
    want, host = _jax_both(case["jesa"], _multiseq(JMultiseq, case["q"]),
                           L, mode, qsp, monkeypatch, flags=2)
    got = tquery.find_query_matches(case["tesa"],
                                    _multiseq(Multiseq, case["q"]), L, mode,
                                    flags_extra=2, qspeedup=qsp)
    _equal(got, want, "default")
    _equal(got, host, "host")
    assert len(got) >= (3 if mode == "mum" else 10)


def _bucket_lanes(esa, q):
    pl = esa.prefixlength
    qcodes, qvalid = bucket_codes(q, esa.alpha.num_regular, pl)
    qpos = np.flatnonzero(qvalid[:q.size] == pl).astype(np.int64)
    bl = esa.bcktab[2 * qcodes[qpos]].astype(np.int64)
    br = esa.bcktab[2 * qcodes[qpos] + 1].astype(np.int64)
    keep = br > bl
    return qpos[keep], bl[keep], br[keep]


def test_findmaxpref_device_equals_the_jax_package(case):
    """Bucket lanes at offset prefixlength and whole-array lanes at
    offset 0 (the qspeedup-5 shape): (maxprefixlen, witness) equal the
    JAX device replay and its host oracle, lane by lane."""
    jesa, tesa, q = case["jesa"], case["tesa"], case["q"]
    qpos, bl, br = _bucket_lanes(jesa, q)
    qlen = np.int64(q.size) - qpos
    pl = jesa.prefixlength
    sub = qpos[::7]
    for lanes in ((bl, br - 1, np.full(qpos.size, pl, np.int64), qpos,
                   qlen),
                  (np.zeros(sub.size, np.int64),
                   np.full(sub.size, jesa.suftab.size - 2, np.int64),
                   np.zeros(sub.size, np.int64), sub,
                   np.int64(q.size) - sub)):
        times = PhaseTimes("cpu")
        with record_phases(times):
            got = tquerydev.findmaxpref_device(tesa, q, *lanes)
        want = jquerydev.findmaxpref_device(jesa, q, *lanes)
        host = jquery._findmaxpref_batch(
            jesa.text, jesa.totallength, jesa.suftab.astype(np.int64),
            *lanes[:3], q, *lanes[3:])
        for g, w, h in zip(got, want, host):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, h)
        assert times.counts["findmaxpref lanes"] == lanes[0].size
        assert times.counts["findmaxpref rounds"] >= 2


def test_mem_expand_device_equals_the_jax_package(case):
    jesa, tesa, q = case["jesa"], case["tesa"], case["q"]
    L = 8 if case["kind"] == "protein" else 14
    qpos, qseq, qoff, rem = jquery._query_positions(
        _multiseq(JMultiseq, q), L)
    proceed, maxlen, wit = jquery._ref_witness_state(
        jesa, _multiseq(JMultiseq, q), L, qpos, qseq, qoff, rem, 2)
    args = (wit[proceed], maxlen[proceed], qpos[proceed], qoff[proceed], L)
    got = tquerydev.mem_expand_device(tesa, q, *args)
    want = jquerydev.mem_expand_device(jesa, q, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].size > 10


def test_witness_state_equals_the_jax_package(case):
    """The host state machine with its device calls: (proceed, maxlen,
    witness) per query position for speedups 0, 2 and 5."""
    q = case["q"]
    for qsp in (0, 2, 5):
        out = []
        for mod, cls, esa in ((tquery, Multiseq, case["tesa"]),
                              (jquery, JMultiseq, case["jesa"])):
            query = _multiseq(cls, q)
            pos = mod._query_positions(query, 12)
            out.append(mod._ref_witness_state(esa, query, 12, *pos, qsp))
        for g, w in zip(*out):
            np.testing.assert_array_equal(g, w)


def test_sparse_table_holds_the_levels_of_the_widest_prefix_run(case):
    """_dev_lcp_rmq keeps the levels that the widest run of lcp >=
    prefixlength needs, fewer than the full table."""
    esa = case["tesa"]
    table, levels, n1 = tquery._dev_lcp_rmq(esa)
    lcp = esa.lcptab
    runs = np.flatnonzero(np.diff(np.concatenate(
        [[0], (lcp >= esa.prefixlength).astype(np.int8), [0]])))
    widest = int((runs[1::2] - runs[0::2]).max()) + 1
    assert levels == repeats_dev._rmq_levels(widest)
    assert levels < int(np.log2(n1)) + 1
    assert table.shape == (levels, n1)
