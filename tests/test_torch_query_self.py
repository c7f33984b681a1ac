"""The port's db-vs-itself MEM pipeline and merged-sort path
(``vstree_tpu_torch/engine/querydev.py``, ``mstats.py`` through
``query.py``) against the JAX package, on the CPU; the inputs and helpers
are :mod:`test_torch_query`'s.

Where the JAX package's fault F3 bites (the db-vs-itself pipeline's
second ladder rung reuses the overflowing scan budget), the port must
give up at once and still equal the host path.
"""

import numpy as np
import pytest
import torch

from conftest import random_dna_text
from test_torch_query import (  # noqa: F401  (fixtures)
    Multiseq,
    _equal,
    _jax_both,
    _multiseq,
    case,
    one_torch_thread,
)

from vstree_tpu.core.alphabet import dna_alphabet as j_dna
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.index.build import build_esa as j_build_esa
from vstree_tpu_torch.device import PhaseTimes, record_phases
from vstree_tpu_torch.engine import query as tquery
from vstree_tpu_torch.engine import querydev as tquerydev
from vstree_tpu_torch.index.esa import ESA


@pytest.mark.parametrize("L", [10, 24])
def test_self_pipeline_equals_the_jax_package(case, L, monkeypatch):
    """db == query: the db-vs-itself pipeline, with replay lanes (the
    duplicated record) and wildcards; equal to both JAX paths."""
    times = PhaseTimes("cpu")
    with record_phases(times):
        got = tquery.find_query_matches(case["tesa"],
                                        case["tesa"].multiseq, L, "mem")
    want, host = _jax_both(case["jesa"], case["jesa"].multiseq, L, "mem", 2,
                           monkeypatch)
    _equal(got, want, "default")
    _equal(got, host, "host")
    assert "self pipeline" in times.seconds
    assert "self pipeline fallbacks" not in times.counts
    assert times.counts["self pipeline replays"] > 0
    assert len(got) > 20


def test_scan_budget_overflow_gives_up_at_once_fault_f3(case, monkeypatch):
    """Fault F3 (vstree_tpu/engine/querydev.py:757): when the hard scan
    lanes overflow their budget H, the JAX pipeline retries with the same
    H, which must overflow again.  The port returns None after ONE
    classification, and find_query_matches then takes the general path
    and equals the JAX host path."""
    calls = []
    real = tquerydev._qself_classify
    monkeypatch.setattr(tquerydev, "_qself_classify",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tquerydev, "_scan_budget", lambda nq: 1)
    tesa = case["tesa"]
    assert tquerydev.find_query_mems_self_device(tesa, tesa.multiseq,
                                                 12) is None
    assert calls == [1]
    got = tquery.find_query_matches(tesa, tesa.multiseq, 12, "mem")
    _, host = _jax_both(case["jesa"], case["jesa"].multiseq, 12, "mem", 2,
                        monkeypatch)
    _equal(got, host)
    assert len(calls) == 2


def test_merged_sort_path_equals_the_jax_package(monkeypatch):
    """A query as long as the database and self-similar to it (its
    reverse complement with planted palindromes): the sampled cost model
    chooses the merged sort in both packages; equal tables."""
    rng = np.random.default_rng(71)
    text = random_dna_text(rng, 24000, n_wild=10, n_sep=5)
    for _ in range(30):
        ln = int(rng.integers(40, 300))
        src, dst = rng.integers(0, text.size - ln, 2)
        text[dst:dst + ln] = 3 - text[src:src + ln][::-1] % 4
    jesa = j_build_esa(_multiseq(JMultiseq, text), j_dna(),
                       demand=("suf", "lcp", "bwt", "bck", "sti"))
    tesa = ESA.from_shared(jesa, "cpu")
    from vstree_tpu.core.multiseq import reverse_complement_inplace as jrc
    from vstree_tpu_torch.core.multiseq import reverse_complement_inplace

    times = PhaseTimes("cpu")
    with record_phases(times):
        got = tquery.find_query_matches(
            tesa, reverse_complement_inplace(_multiseq(Multiseq, text)), 14,
            "mem", flags_extra=6)
    want, host = _jax_both(jesa, jrc(_multiseq(JMultiseq, text)), 14, "mem",
                           2, monkeypatch, flags=6)
    _equal(got, want, "default")
    _equal(got, host, "host")
    assert times.counts["merged sorts"] == 1 and len(got) > 20


@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
def test_scan_sparse_equals_the_plain_descent(case, right):
    """The gallop with its singleton fast path against the aligned
    descent of query.py, at depths that reach across whole runs."""
    table, levels, n1 = tquery._dev_lcp_rmq(case["tesa"])
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, n1, 3000))
    dep = torch.from_numpy(rng.integers(case["jesa"].prefixlength, 40,
                                        3000))
    got, bad = tquerydev._scan_sparse(table, idx, dep, levels, n1, 3000,
                                      right)
    plain = (tquery._scan_right_dev if right else tquery._scan_left_dev)(
        table, idx, dep, levels, n1)
    assert not bool(bad)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert bool((got != idx).any())
