"""K1's plan without the TPU guards: the port's ``RankLookupPlan`` takes
an index whose widest bucket the JAX plan refuses (wider than the Pallas
kernel's window of 8 x 128 ranks, or than its 31-bit packing of a
bracket), and then answers as the JAX package's packed-key search does.
Where the JAX plan is ok, both plans agree on ppl, coverage, chars per
word and sigma.

On a protein index with a low-complexity run, on a DNA FASTA with poly-A
and poly-T tracts through both CLIs (``vmatch -complete -q`` and
``-complete -e 1 -q``), and on plain indexes for the plans.  Inputs are
made with numpy from a seed; rank intervals and stdout must be equal.
"""

import io

import numpy as np
import pytest

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import complete as jcomplete
from vstree_tpu.index.build import build_esa
from vstree_tpu.index.io import read_index
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch
from vstree_tpu_torch.device import PhaseTimes, record_phases
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.index.esa import ESA

# the JAX plan's widest bucket: its window (rowspan <= 8)
TPU_WINDOW = 8 * 128 - 254


def _esa(text, alpha):
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    return build_esa(ms, alpha, demand=("suf",))


def _protein_text(run):
    """20,000 residues with wildcards, separators and, with ``run``, a
    poly-Q stretch of 1,000 (its depth-4 bucket ~1,000 ranks wide)."""
    rng = np.random.default_rng(51)
    t = rng.integers(0, 20, 20_000).astype(np.uint8)
    t[rng.choice(t.size, 12, replace=False)] = 254
    t[rng.choice(t.size, 4, replace=False)] = 255
    if run:
        t[6_000:7_000] = 5
    return t


def _windows(text, sigma, num, lo, hi, seed, run=None):
    """Windows of the text free of specials, every fifth random, and
    with ``run`` = (start, end) every seventh inside that run."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, num)
    m = np.full((num, hi), -1, np.int32)
    for i, ln in enumerate(lens):
        if i % 5 == 4:
            p = rng.integers(0, sigma, ln)
        elif run is not None and i % 7 == 0:
            s = int(rng.integers(run[0], run[1] - ln))
            p = text[s:s + ln]
        else:
            while True:
                s = int(rng.integers(0, text.size - ln))
                p = text[s:s + ln]
                if (p < sigma).all():
                    break
        m[i, :ln] = p
    return m, lens.astype(np.int32)


def test_protein_run_index_k1_equals_jax_key_search():
    """sigma = 20, ppl 4, coverage 18: the poly-Q bucket is wider than
    the TPU window, so the JAX plan refuses and searches packed keys;
    the port's K1 path finds the same intervals."""
    text = _protein_text(True)
    jesa = _esa(text, protein_alphabet())
    tesa = ESA.from_shared(jesa, "cpu")
    m, plens = _windows(text, 20, 1500, 6, 18, 52, run=(6_000, 7_000))
    assert not jcomplete.RankLookupPlan(jesa, 6, 18).ok
    plan = tcomplete.RankLookupPlan(tesa, 6, 18)
    assert plan.ok and (plan.ppl, plan.cpw, plan.coverage) == (4, 7, 18)
    assert int(plan.bck[1::2].max()) > TPU_WINDOW
    times = PhaseTimes("cpu")
    with record_phases(times):
        got = tcomplete.exact_interval_lookup(tesa, m, plens)
    assert "rank lookup" in times.seconds
    want = jcomplete.exact_interval_lookup(jesa, m, plens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] - got[0]).max() > 900   # poly-Q windows
    assert (got[1] > got[0]).sum() > 1000


def _plan_cases():
    """(kind, text, min, max) for the plan comparison: uniform texts at
    every bucket depth from 1 up, beyond the coverage, and the run
    texts the JAX plan refuses."""
    rng = np.random.default_rng(53)
    dna = rng.integers(0, 4, 20_000).astype(np.uint8)
    dna[rng.choice(dna.size, 9, replace=False)] = 254
    tract = dna.copy()
    tract[5_000:6_200] = 0
    cases = []
    for text, kind in ((dna, "dna"), (tract, "dna"),
                       (_protein_text(False), "protein"),
                       (_protein_text(True), "protein")):
        for lo, hi in ((1, 12), (3, 20), (6, 18), (10, 36), (24, 36),
                       (20, 37), (40, 60)):
            cases.append((kind, text, lo, hi))
    return cases


def test_plans_agree_where_the_jax_plan_is_ok():
    """The port's plan takes a superset of the JAX plan's indexes, with
    the same ppl, coverage, chars per word and sigma on every one; it
    refuses only patterns beyond the coverage."""
    seen = {"both": 0, "port only": 0, "neither": 0}
    built = {}
    for kind, text, lo, hi in _plan_cases():
        alpha = dna_alphabet() if kind == "dna" else protein_alphabet()
        key = id(text)
        if key not in built:
            jesa = _esa(text, alpha)
            built[key] = (jesa, ESA.from_shared(jesa, "cpu"))
        jesa, tesa = built[key]
        jplan = jcomplete.RankLookupPlan(jesa, lo, hi)
        tplan = tcomplete.RankLookupPlan(tesa, lo, hi)
        assert (tplan.ppl, tplan.coverage, tplan.cpw, tplan.sigma) == (
            jplan.ppl, jplan.coverage, jplan.cpw, jplan.sigma)
        assert tplan.ok == (hi <= tplan.coverage)
        assert tplan.ok or not jplan.ok
        seen["both" if jplan.ok else
             "port only" if tplan.ok else "neither"] += 1
        if jplan.ok:
            want = np.asarray(jplan.bck).reshape(-1)[:jplan.sigma
                                                     ** jplan.ppl + 1]
            want = want.astype(np.int64) & 0xFFFFFFFF
            got = tplan.bck.numpy().reshape(-1, 2)
            np.testing.assert_array_equal(
                got[:, 0], want & ((1 << jplan.shift) - 1))
            np.testing.assert_array_equal(got[:, 1], want >> jplan.shift)
    assert min(seen.values()) >= 3, seen


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">r{i} tract record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def tract_cli(tmp_path_factory):
    """Three records of 6-8 kbp with a/t tracts of 10-25 (one per
    400 bp) and one poly-A and one poly-T tract of 1,100; both packages'
    indexes and two query files: 80 windows of 24-36 (every 24th in the
    poly-A tract) and 60 of 20-32 with 0-1 substitutions."""
    tmp = tmp_path_factory.mktemp("rankguard")
    rng = np.random.default_rng(55)
    recs = []
    for n in (6_000, 8_000, 7_000):
        s = rng.integers(0, 4, n)
        for st in rng.integers(0, n - 25, n // 400):
            s[st:st + int(rng.integers(10, 26))] = rng.choice([0, 3])
        recs.append(s)
    recs[0][2_000:3_100] = 0
    recs[2][1_000:2_100] = 3
    dna = ["".join("acgt"[c] for c in r) for r in recs]
    exact, edit = [], []
    for i in range(80):
        ln = int(rng.integers(24, 37))
        r = dna[i % 3]
        st = (int(rng.integers(2_000, 3_100 - ln)) if i % 24 == 0
              else int(rng.integers(0, len(r) - ln)))
        exact.append(r[st:st + ln])
    for i in range(60):
        ln = int(rng.integers(20, 33))
        r = dna[i % 3]
        st = int(rng.integers(0, len(r) - ln))
        q = list(r[st:st + ln])
        if i % 2:
            at = int(rng.integers(0, ln))
            q[at] = "acgt"[("acgt".index(q[at]) + 1) % 4]
        edit.append("".join(q))
    out = {"exact": _fasta(tmp / "qx.fna", exact),
           "edit": _fasta(tmp / "qe.fna", edit)}
    fasta = _fasta(tmp / "tracts.fna", dna)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        for pkg, run in (("jax", jmkvtree.run),
                         ("torch", lambda a: tmkvtree.run(a, "cpu"))):
            out[pkg] = str(tmp / pkg)
            assert run(["-db", fasta, "-dna", "-pl", "-allout",
                        "-indexname", out[pkg]]) == 0
    return out


def _vmatch(run, argv):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert run(argv, buf) == 0
    return buf.getvalue()


@pytest.mark.parametrize("extra,queries", [([], "exact"),
                                           (["-e", "1"], "edit")],
                         ids=["exact", "e1"])
def test_vmatch_complete_on_tracts_byte_identical(tract_cli, extra,
                                                  queries):
    """The port's CLI (K1's path) prints the JAX CLI's bytes (the key
    search's) on the tract index."""
    argv = ["-complete"] + extra + ["-q", tract_cli[queries],
                                    tract_cli["torch"]]
    times = PhaseTimes("cpu")
    with record_phases(times):
        got = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o), argv)
    assert "rank lookup" in times.seconds
    assert "key search" not in times.seconds
    # the JAX plan refuses the index at the depth of both runs
    assert not jcomplete.RankLookupPlan(read_index(tract_cli["jax"]), 10,
                                        36).ok
    assert got == want
    rows = [ln for ln in got.splitlines() if ln[:1] != "#"]
    assert len(rows) > 100
