"""Port vs JAX package: ``chainqhits`` (q-gram hits of a query on an
index and their on-the-fly chaining, ``postprocess/onflychain.py``).

The four modes give the same stdout on an index built by either package:
``nocheckqhit`` and ``nocheckleast`` stream the chains, ``checkqhit`` and
``checkleast`` hold the on-the-fly scores against the tool's own
brute-force chaining.  The hits themselves (``produce_qhits``) are equal
arrays; a malformed call fails alike.
"""

import contextlib
import io

import numpy as np
import pytest

from vstree_tpu.cli import chainqhits as jchainqhits
from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.core.multiseq import read_multiseq as j_read_multiseq
from vstree_tpu.index.io import read_index as j_read_index
from vstree_tpu.postprocess import onflychain as jonfly
from vstree_tpu_torch.cli import chainqhits as tchainqhits
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.core.multiseq import read_multiseq
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.postprocess import onflychain as tonfly

MODES = ("nocheckqhit", "nocheckleast", "checkqhit", "checkleast")


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">c{i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _mutate(rng, s, rate):
    s = np.array(list(s))
    at = rng.random(s.size) < rate
    s[at] = rng.choice(list("acgt"), int(at.sum()))
    return "".join(s)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 16 kb database and a query of 3 kb made of its windows at 3 %
    substitutions between random stretches."""
    tmp = tmp_path_factory.mktemp("qhits")
    rng = np.random.default_rng(17)
    db = ["".join(rng.choice(list("acgt"), n)) for n in (9000, 7000)]
    parts = []
    for k in range(8):
        parts.append("".join(rng.choice(list("acgt"),
                                        int(rng.integers(50, 200)))))
        src = db[k % 2]
        st = int(rng.integers(0, len(src) - 300))
        parts.append(_mutate(rng, src[st:st + int(rng.integers(80, 300))],
                             0.03))
    files = {"db": _fasta(tmp / "db.fna", db),
             "q": _fasta(tmp / "q.fna", ["".join(parts)])}
    for pkg, run in (("jax", jmkvtree.run),
                     ("torch", lambda a: tmkvtree.run(a, "cpu"))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(["-db", files["db"], "-dna", "-pl", "-tis", "-suf",
                        "-bck", "-lcp", "-sti1", "-indexname",
                        str(tmp / pkg)]) == 0
        files[pkg] = str(tmp / pkg)
    return files


def _run(run, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", ["jax", "torch"])
def test_chainqhits_same_stdout(data, mode, which):
    argv = ["12", "2", data[which], data["q"], mode]
    want = _run(jchainqhits.run, argv)
    got = _run(lambda a: tchainqhits.run(a, "cpu"), argv)
    assert got == want
    assert want[0] == 0
    if mode.startswith("check"):
        # the on-the-fly chaining equals the brute-force one
        assert want[1].startswith("# check okay: ")
        assert int(want[1].split()[3]) > 30
    else:
        assert want[1].count("chain ") > 5


@pytest.mark.parametrize("onlyqhits", [True, False])
@pytest.mark.parametrize("length", [10, 16])
def test_produce_qhits_same_arrays(data, onlyqhits, length):
    jesa = j_read_index(data["torch"])
    esa = ESA.read(data["torch"], "cpu")
    jq = j_read_multiseq([data["q"]], jesa.alpha)
    q = read_multiseq([data["q"]], esa.alpha)
    want = jonfly.produce_qhits(jesa, jq.sequence, length, onlyqhits)
    got = tonfly.produce_qhits(esa, q.sequence, length, onlyqhits)
    assert want[0].size > 20
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("argv", [
    ["12", "2", "IDX", "Q"],
    ["12", "0", "IDX", "Q", "checkqhit"],
    ["x", "2", "IDX", "Q", "checkqhit"],
    ["12", "2", "IDX", "Q", "check"],
    ["2", "2", "IDX", "Q", "checkqhit"],
], ids=["four_args", "edist0", "length_x", "bad_mode", "below_prefix"])
def test_malformed_calls_fail_alike(data, argv):
    argv = [{"IDX": data["torch"], "Q": data["q"]}.get(a, a) for a in argv]
    want = _run(jchainqhits.run, argv)
    got = _run(lambda a: tchainqhits.run(a, "cpu"), argv)
    assert got == want and want[0] == 1 and want[2]
