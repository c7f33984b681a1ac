"""The port stands alone: no file of ``vstree_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``vstree_tpu``, and
the modules the port copied from the JAX package give the same bytes as
the originals.  The port's benchmark (``bench_torch/``) imports neither,
nor ``chip_smoke``.
"""

import ast
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from vstree_tpu.core.alphabet import dna_alphabet as j_dna_alphabet
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.engine import funnel as jfunnel
from vstree_tpu.engine.match import MatchTable as JMatchTable
from vstree_tpu.index import io as jio
from vstree_tpu.index.build import build_esa as j_build_esa
from vstree_tpu.output import render as jrender
from vstree_tpu.stats.evalues import Evalues as JEvalues
from vstree_tpu_torch.core.alphabet import dna_alphabet
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.engine import funnel as tfunnel
from vstree_tpu_torch.engine.match import (
    FLAGCOMPLETEMATCH,
    FLAGQUERY,
    MatchTable,
)
from vstree_tpu_torch.index import io as tio
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.output import render as trender
from vstree_tpu_torch.stats.evalues import Evalues

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "vstree_tpu")
PORT_FILES = sorted((REPO / "vstree_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
BENCH_FILES = sorted((REPO / "bench_torch").rglob("*.py"))
COPIED = ("core/chardef.py", "core/alphabet.py", "core/multiseq.py",
          "engine/match.py", "engine/funnel.py", "stats/evalues.py",
          "index/io.py", "output/align.py",
          "output/xdropalign.py", "engine/tandem.py", "engine/mumself.py",
          "core/optdesc.py", "postprocess/__init__.py",
          "postprocess/select.py", "output/xml.py", "postprocess/mask.py",
          "postprocess/cluster.py", "postprocess/dbcluster.py",
          "postprocess/chain.py", "postprocess/matchcluster.py",
          "engine/vplugin.py", "postprocess/onflychain.py",
          "core/encseq.py", "index/stream.py", "stats/karlin.py",
          "postprocess/matchfile.py", "cli/vmatchselect.py",
          "cli/chain2dim.py", "cli/matchcluster.py", "cli/vseqinfo.py",
          "cli/vseqselect.py", "cli/vsubseqselect.py", "cli/vendian.py",
          "cli/vstree2tex.py", "cli/mksti.py", "cli/mkiso.py",
          "cli/mklsf.py", "cli/mkvcmp.py", "cli/mkcld.py")
EXTS = ("tis", "suf", "lcp", "llv", "bwt", "bck", "sti1", "skp", "ssp",
        "des", "sds", "al1", "prj")


def _imported_roots(path: Path) -> set[str]:
    """Top-level packages a file imports absolutely, anywhere in it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(BANNED)
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in BANNED, line


@pytest.mark.parametrize("path", BENCH_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_benchmark_imports_no_jax_nor_chip_smoke(path):
    banned = set(BANNED) | {"chip_smoke"}
    assert not _imported_roots(path) & banned
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in banned, line


def test_the_benchmark_scan_sees_every_module():
    assert {p.name for p in BENCH_FILES} == {
        "__init__.py", "__main__.py", "bounds.py", "cells.py", "checks.py",
        "data.py", "host.py", "make_digests.py", "trace.py"}


_BENCH_BLOCKED = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    for name in ("jax", "vstree_tpu", "chip_smoke"):
        sys.modules[name] = None      # any import of it now fails
    import bench_torch
    for m in pkgutil.walk_packages(bench_torch.__path__, "bench_torch."):
        importlib.import_module(m.name)
    from bench_torch.cells import Bench
    bench = Bench("cpu", work=sys.argv[1], log=lambda *a: None, sizes={
        "yeast-r64-dna": {"lengths": [6000] * 4},
        "complete-exact-100k-yeast": {"count": 50}})
    line = bench.run("complete-exact-100k-yeast", repeats=1)
    assert line["correct"] and line["digest"]["rows"] >= 50
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "vstree_tpu", "chip_smoke"))
    assert loaded == ["chip_smoke", "jax", "vstree_tpu"], loaded
    print(json.dumps(line["checks"]))
""")


def test_benchmark_runs_with_jax_blocked(tmp_path):
    """A subprocess blocks jax, vstree_tpu and chip_smoke, imports every
    module of ``bench_torch``, and runs a cell on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _BENCH_BLOCKED, str(tmp_path)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert '"queries": 50' in r.stdout


def test_the_scan_sees_the_whole_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"vstree_tpu_torch/engine/approx.py",
            "vstree_tpu_torch/engine/gextend.py",
            "vstree_tpu_torch/engine/gextend_dev.py",
            "vstree_tpu_torch/engine/xdrop.py",
            "vstree_tpu_torch/ops/lce.py",
            "vstree_tpu_torch/engine/query.py",
            "vstree_tpu_torch/engine/querydev.py",
            "vstree_tpu_torch/engine/mstats.py",
            "vstree_tpu_torch/engine/onlinequery.py",
            "vstree_tpu_torch/native/myers.py",
            "vstree_tpu_torch/index/io.py", "chip_smoke.py",
            "vstree_tpu_torch/core/codon.py",
            "vstree_tpu_torch/cli/chainqhits.py",
            "vstree_tpu_torch/postprocess/onflychain.py",
            "vstree_tpu_torch/plugins/vmotif-demo.py",
            "vstree_tpu_torch/index/merge.py",
            "vstree_tpu_torch/cli/repfind.py",
            "vstree_tpu_torch/parallel/mesh.py",
            "vstree_tpu_torch/parallel/shardesa.py",
            "vstree_tpu_torch/parallel/distributed.py"} <= names
    assert len(names) >= 70
    kernels = {p.name for p in
               (REPO / "vstree_tpu_torch/native/csrc").glob("*.cu")}
    assert kernels == {"rankcount.cu", "myers.cu"}


def _tree(path: Path) -> ast.Module:
    """A module's syntax tree without its docstrings (comments are no
    part of it)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return tree


def _code(path: Path) -> str:
    return ast.dump(_tree(path))


def _statements(path: Path) -> dict[str, str]:
    """A module's top-level statements by the name they define (imports
    by their text)."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, ast.Assign):
            name = ast.unparse(node.targets[0])
        else:
            name = getattr(node, "name", None) or ast.unparse(node)
        out[name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_the_original(rel):
    """A copy holds the code of its original, statement for statement
    (the imports are relative in both); only prose may differ."""
    assert (_code(REPO / "vstree_tpu_torch" / rel)
            == _code(REPO / "vstree_tpu" / rel))


def test_repeats_copy_departs_in_two_places():
    """``engine/repeats.py`` is the original but for the switch
    ``_use_device_engines``, which the port does not have, and
    ``find_maximal_pairs_ref``, which always runs the torch program (and
    so imports the phase timer)."""
    rel = "engine/repeats.py"
    port = _statements(REPO / "vstree_tpu_torch" / rel)
    orig = _statements(REPO / "vstree_tpu" / rel)
    assert set(orig) - set(port) == {"_use_device_engines"}
    assert set(port) - set(orig) == {"from ..device import phase"}
    differ = {name for name in port if name in orig
              and port[name] != orig[name]}
    assert differ == {"find_maximal_pairs_ref"}
    assert len(port) >= 20
    source = (REPO / "vstree_tpu_torch" / rel).read_text()
    assert "environ" not in source and "maximal_pairs_device" in source


def _departures(rel):
    """(names only in the original, names only in the port, names whose
    statements differ) of a partly copied module."""
    port = _statements(REPO / "vstree_tpu_torch" / rel)
    orig = _statements(REPO / "vstree_tpu" / rel)
    differ = {name for name in port if name in orig
              and port[name] != orig[name]}
    return set(orig) - set(port), set(port) - set(orig), differ


def test_render_copy_adds_the_row_matrix_renderer():
    """``output/render.py`` is the original, ``render_matches`` statement
    for statement, plus ``render_rows``: the same rows from torch ops
    over a byte matrix, with its helpers and chunk size."""
    gone, new, differ = _departures("output/render.py")
    assert not gone and not differ
    assert new == {"import torch", "_RENDER_ROWS", "_FILL", "_COMPACT",
                   "_POW10", "render_rows", "render_row_chunks",
                   "_render_chunk", "_filenums", "_column", "_row_text",
                   "_integers", "_text"}
    port = _statements(REPO / "vstree_tpu_torch/output/render.py")
    assert port["render_matches"] == _statements(
        REPO / "vstree_tpu/output/render.py")["render_matches"]


def test_lce_copy_is_the_numpy_function_of_the_original():
    """``ops/lce.py`` keeps ``lce_two_texts`` alone: the original module
    imports jax at its top, and nothing calls its device variant."""
    gone, new, differ = _departures("ops/lce.py")
    assert gone == {"import functools", "import jax",
                    "import jax.numpy as jnp", "_lce_round",
                    "lce_two_texts_device"}
    assert not new and not differ
    assert "lce_two_texts" in _statements(
        REPO / "vstree_tpu_torch/ops/lce.py")


def test_gextend_copy_departs_in_seqs_and_the_edit_entry_points():
    """``engine/gextend.py`` is the original but for ``Seqs`` (tensors on
    an explicit device, LCE sweeps through the ladder there), the two
    edit entry points (no ``_use_device_engines`` switch: always
    ``edit_fronts_viable_device`` on the device of ``sq``, whose
    survivors' fronts stay there for ``_extend_combine_device``, the
    combination as torch ops, ``gextend_dev.combine_fronts``) and the
    host ``edit_fronts``, which nothing reaches any more.  The NumPy
    ``_extend_combine`` stays the original's, statement for statement:
    the plain reference of the device combination."""
    gone, new, differ = _departures("engine/gextend.py")
    assert gone == {
        "edit_fronts",
        "from ..core.chardef import SEPARATOR, WILDCARD",
        "from ..ops.lce import lce_two_texts",
        "from .match import FLAGPALINDROMIC, FLAGQUERY, MatchTable"}
    assert new == {
        "import torch", "from ..core.chardef import SEPARATOR",
        "from ..device import phase",
        "from ..index.sort import device_lce_pairs",
        "from .gextend_dev import _dev_tables, combine_fronts, "
        "edit_fronts_viable_device",
        "_extend_combine_device",
        "from .match import MatchTable",
        "from .repeats import _pairs_to_matchtable",
        "from .repeats_dev import _emission_order, "
        "maximal_pairs_device_seeds"}
    assert differ == {"Seqs", "edit_extend_seeds", "edit_extend_self_device"}
    copied = set(_statements(REPO / "vstree_tpu_torch/engine/gextend.py"))
    assert {"_char", "hamming_look_left", "hamming_look_right", "_better",
            "hamming_extend_seeds", "_sep_dist_left", "_sep_dist_right",
            "_extend_combine", "_contains", "container_insert",
            "apply_allmax_containers", "NEG"} <= copied - differ
    source = (REPO / "vstree_tpu_torch/engine/gextend.py").read_text()
    assert "_use_device_engines()" not in source
    assert "environ" not in source
    # the edit entry points reach neither the host fronts nor the NumPy
    # combination; edit_fronts_viable is the device function + a download
    calls = _calls(REPO / "vstree_tpu_torch/engine/gextend.py")
    for name in ("edit_extend_seeds", "edit_extend_self_device"):
        assert {"edit_fronts_viable_device", "_extend_combine_device"} <= (
            calls[name])
        assert not {"edit_fronts_viable", "_extend_combine"} & calls[name]
    assert "combine_fronts" in calls["_extend_combine_device"]
    assert not any("_extend_combine" in c for c in calls.values())
    dev = _calls(REPO / "vstree_tpu_torch/engine/gextend_dev.py")
    assert "edit_fronts_viable_device" in dev["edit_fronts_viable"]
    assert not any("edit_fronts_viable" in c for c in dev.values())


def test_codon_copy_departs_in_the_six_frame_loops():
    """``core/codon.py`` is the original but for ``six_frame_translate``
    (frame by frame over all records at once; ``translate_forward`` and
    ``translate_backward`` only to raise an illegal char's error) and
    ``sixframe_convert_match`` (the records' bounds by array lookups in
    ``markpos``), with their helpers.  Neither loops over records or
    rows."""
    gone, new, differ = _departures("core/codon.py")
    assert not gone
    assert new == {"_FRAMES", "_SHIFT", "_record_bounds"}
    assert differ == {"six_frame_translate", "sixframe_convert_match"}
    copied = set(_statements(REPO / "vstree_tpu_torch/core/codon.py"))
    assert {"SCHEMES", "_build_tables", "_third_base_aa", "translate_forward",
            "translate_backward", "check_transnum"} <= copied - differ
    fns = {name: _function("core/codon.py", name, "vstree_tpu_torch")
           for name in differ}
    loops = [ast.unparse(node.iter) for fn in fns.values()
             for node in ast.walk(fn)
             if isinstance(node, (ast.For, ast.While, ast.comprehension))]
    assert loops == ["enumerate(_FRAMES)"]
    assert "seq_bounds" not in ast.unparse(fns["sixframe_convert_match"])


def _calls(path: Path) -> dict[str, set[str]]:
    """The names each top-level function of a module calls."""
    return {node.name: {ast.unparse(c.func) for c in ast.walk(node)
                        if isinstance(c, ast.Call)}
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.FunctionDef)}


def test_xdrop_copy_departs_where_the_lce_sweeps_are():
    """``engine/xdrop.py`` is the original but for the functions that
    call the LCE: they take the ``Seqs`` object and a direction and sweep
    on its device; ``edit_xdrop_batch`` also keeps its state to the live
    seeds and their diagonals."""
    gone, new, differ = _departures("engine/xdrop.py")
    assert gone == {"from ..core.chardef import SEPARATOR, WILDCARD",
                    "from ..ops.lce import lce_two_texts"}
    assert new == {"from ..core.chardef import SEPARATOR", "_texts",
                   "_XDROP_CAP"}
    assert differ == {"_slide", "edit_xdrop_batch", "hamming_xdrop_batch",
                      "xdrop_extend_seeds"}
    assert {"_ctrunc_div", "_char_at", "_accept_match", "NEG", "MATCHSCORE"
            } <= set(_statements(REPO / "vstree_tpu_torch/engine/xdrop.py"))


def test_query_copy_departs_where_the_device_is():
    """``engine/query.py`` is the original but for its device programs
    (the sparse table of the widest prefix run, the scan descents in
    torch), ``find_query_matches`` without the ``VSTREE_HOST_QUERY``
    switch and its host MEM expansion, and ``_findmaxpref_batch``, the
    host oracle that stays in the JAX package.  The host state machine
    ``_ref_witness_state`` (cost model, sti1 fix-up) and the emission are
    the original's statements."""
    gone, new, differ = _departures("engine/query.py")
    assert gone == {"_findmaxpref_batch", "import functools", "import math",
                    "import jax", "import jax.numpy as jnp",
                    "from jax import lax",
                    "from ..ops.lce import lce_two_texts",
                    "from .repeats import LcpRmq, _l_runs"}
    assert new == {"_scan_batch", "from ..device import phase",
                   "import torch"}
    assert differ == {"_dev_lcp_rmq", "_scan_left_dev", "_scan_right_dev",
                      "_scan_left_batch", "_scan_right_batch",
                      "find_query_matches"}
    assert {"_query_positions", "_compare_batch", "_ref_witness_state",
            "_emit_prefiltered", "_emit", "_unique_in_query"} <= set(
        _statements(REPO / "vstree_tpu_torch/engine/query.py")) - differ
    source = (REPO / "vstree_tpu_torch/engine/query.py").read_text()
    assert "environ" not in source and "mem_expand_device" in source


def test_onlinequery_copy_departs_in_the_device_argument():
    """``engine/onlinequery.py`` is the original but for the device of
    the throwaway index and of the extensions' sequences: the database
    index's (``build_esa(..., device=esa.dev)``, ``Seqs(..., esa.dev)``).
    Without those two arguments the code is the original's."""
    rel = "engine/onlinequery.py"
    tree = _tree(REPO / "vstree_tpu_torch" / rel)
    dropped = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "build_esa":
                kw = node.keywords.pop()
                dropped.append((kw.arg, ast.unparse(kw.value)))
            elif node.func.id == "Seqs":
                dropped.append(("Seqs", ast.unparse(node.args.pop())))
    assert sorted(dropped) == [("Seqs", "esa.dev"), ("device", "esa.dev")]
    assert ast.dump(tree) == _code(REPO / "vstree_tpu" / rel)


@pytest.mark.parametrize("rel,kept", [
    ("cli/chain2dim.py", "parse_chain_args"),
    ("cli/matchcluster.py", "parse_matchcluster_args"),
])
def test_cli_parse_copies_lack_only_the_tools(rel, kept):
    """The chain2dim and matchcluster tools, whose option parses ``vmatch
    -pp`` reuses, now lack nothing: with ``postprocess/matchfile.py``
    copied, ``run`` and ``main`` are the originals' too."""
    gone, new, differ = _departures(rel)
    assert not gone and not new and not differ
    assert {kept, "run", "main",
            "from ..postprocess.matchfile import read_match_file"} <= set(
        _statements(REPO / "vstree_tpu_torch" / rel))


def _without_device(fn: ast.AST) -> str:
    """A function's source with what the port adds for its device taken
    out: the keyword-only ``device`` parameter, ``device=device``
    arguments, and its instrumentation: ``with phase(...)`` blocks
    (their bodies stay) and ``count(...)`` calls."""
    fn.args.kwonlyargs = [a for a in fn.args.kwonlyargs
                          if a.arg != "device"]
    fn.args.kw_defaults = fn.args.kw_defaults[:len(fn.args.kwonlyargs)]
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        body = getattr(node, "body", None)
        if isinstance(body, list):
            flat = []
            for st in body:
                if (isinstance(st, ast.With)
                        and ast.unparse(st.items[0].context_expr)
                        .startswith("phase(")):
                    flat.extend(st.body)
                elif (isinstance(st, ast.Expr)
                      and ast.unparse(st).startswith("count(")):
                    continue
                else:
                    flat.append(st)
            node.body = flat
    return ast.unparse(fn)


def _function(rel: str, name: str, pkg: str) -> ast.AST:
    tree = _tree(REPO / pkg / rel)
    return next(n for n in ast.walk(tree)
                if getattr(n, "name", None) == name)


def test_merge_copy_departs_in_the_cross_counts():
    """``index/merge.py`` is the original but for the cross counts:
    ``_cross_counts`` runs its binary search on torch tensors of the
    given device and takes each probe's LCE from the two-text ladder,
    ``_cross_rel`` decides on the characters at that LCE (the
    original's rule), ``_sigma`` sizes the packed words.
    ``merge_indexes`` only passes the device on and times its two
    stages."""
    gone, new, differ = _departures("index/merge.py")
    assert not gone
    assert new == {"import torch", "from ..device import phase",
                   "from .sort import _lce_tables, device_lce_pairs, "
                   "lce_pack_params", "_sigma"}
    assert differ == {"_cross_rel", "_cross_counts", "merge_indexes"}
    port = _without_device(_function("index/merge.py", "merge_indexes",
                                     "vstree_tpu_torch"))
    orig = ast.unparse(_function("index/merge.py", "merge_indexes",
                                 "vstree_tpu"))
    assert port == orig


def test_out_of_core_build_departs_in_the_device_and_the_lcp_pass():
    """``build_suf_out_of_core`` is the JAX function but for its
    ``device`` (the shard sorts and the merge run there, its phases are
    timed) and the lcp pass: ``_lcp_pairs_device_chunked``, the ladder on
    the device in chunks of pairs, where the original compares windows
    on the host (``_lcp_pairs_host_chunked``, which the port lacks)."""
    port = _without_device(_function("index/build.py",
                                     "build_suf_out_of_core",
                                     "vstree_tpu_torch"))
    orig = ast.unparse(_function("index/build.py", "build_suf_out_of_core",
                                 "vstree_tpu"))
    assert orig.replace(
        "_lcp_pairs_host_chunked(gtext, suftab[:n - 1], suftab[1:n])",
        "_lcp_pairs_device_chunked(gtext, suftab[:n - 1], suftab[1:n], "
        "alpha.num_regular)") == port
    statements = _statements(REPO / "vstree_tpu_torch/index/build.py")
    assert "_lcp_pairs_device_chunked" in statements
    assert "_lcp_pairs_host_chunked" not in statements


@pytest.mark.parametrize("rel,replace", [
    ("cli/mkcfr.py", [
        ("from ..engine.complete import exact_interval_lookup\n"
         "from ..index.io import read_index",
         "from ..device import cuda_device\n"
         "from ..engine.complete import exact_interval_lookup\n"
         "from ..index.esa import ESA"),
        ("read_index(indexname,", "ESA.read(indexname, device,"),
        ("read_index(indexname + '.rev',",
         "ESA.read(indexname + '.rev', device,")]),
    ("cli/mkrcidx.py", [
        ("from ..index.build import build_esa",
         "from ..device import cuda_device\n"
         "from ..index.build import build_esa"),
        ("demand=('suf', 'lcp', 'bwt'))",
         "demand=('suf', 'lcp', 'bwt'), device=device)")]),
    ("cli/mkdna6idx.py", [
        ("from ..index.build import build_esa",
         "from ..device import cuda_device\n"
         "from ..index.build import build_esa"),
        ("demand=('suf', 'lcp', 'bwt'))",
         "demand=('suf', 'lcp', 'bwt'), device=device)")]),
    ("cli/repfind.py", [
        ("import sys\n", "import sys\nfrom ..device import cuda_device\n"),
        ("_call(mkvtree_cli.run,",
         "_call(lambda args: mkvtree_cli.run(args, device),"),
        ("_call(vmatch_cli.run,",
         "_call(lambda args: vmatch_cli.run(args, device),")]),
], ids=lambda x: x if isinstance(x, str) else "")
def test_device_tools_depart_in_the_device(rel, replace):
    """``mkcfr``, ``mkrcidx``, ``mkdna6idx`` and ``repfind`` are the
    originals but for the device: ``run(argv, device)`` looks up, builds
    or calls the port's CLIs on the device it is given, ``main`` asks
    for the CUDA card."""
    gone, new, differ = _departures(rel)
    assert new == {"from ..device import cuda_device"} | (
        {"from ..index.esa import ESA"} if rel == "cli/mkcfr.py" else set())
    assert gone == ({"from ..index.io import read_index"}
                    if rel == "cli/mkcfr.py" else set())
    assert differ == {"run", "main"}
    port = ast.unparse(_tree(REPO / "vstree_tpu_torch" / rel))
    orig = ast.unparse(_tree(REPO / "vstree_tpu" / rel)).replace(
        "def run(argv: list[str]) -> int:",
        "def run(argv: list[str], device) -> int:").replace(
        "run(sys.argv[1:])", "run(sys.argv[1:], cuda_device())")
    for a, b in replace:
        assert a in orig, a
        orig = orig.replace(a, b)
    assert orig == port


def test_chainqhits_copy_departs_in_the_device():
    """``cli/chainqhits.py`` is the original but for the device: ``run``
    reads the index onto the device it is given, ``main`` asks for the
    CUDA card."""
    gone, new, differ = _departures("cli/chainqhits.py")
    assert gone == {"from ..index.io import read_index"}
    assert new == {"from ..device import cuda_device",
                   "from ..index.esa import ESA"}
    assert differ == {"run", "main"}
    port = ast.unparse(_tree(REPO / "vstree_tpu_torch/cli/chainqhits.py"))
    orig = ast.unparse(_tree(REPO / "vstree_tpu/cli/chainqhits.py"))
    assert orig.replace(
        "def run(argv: list[str]) -> int:",
        "def run(argv: list[str], device) -> int:").replace(
        "read_index(indexname)", "ESA.read(indexname, device)").replace(
        "run(sys.argv[1:])", "run(sys.argv[1:], cuda_device())").replace(
        "from ..index.io import read_index",
        "from ..device import cuda_device\nfrom ..index.esa import ESA"
    ) == port


def test_vmotif_demo_plugin_imports_the_port(tmp_path):
    """The port's demo vplugin is the JAX package's but for the engine it
    imports: a plugin loads by path, and the port's CLI must never load a
    file of the JAX package."""
    orig = (REPO / "vstree_tpu/plugins/vmotif-demo.py").read_text()
    ported = tmp_path / "vmotif-demo.py"
    ported.write_text(orig.replace("from vstree_tpu.engine.complete",
                                   "from vstree_tpu_torch.engine.complete"))
    port = REPO / "vstree_tpu_torch/plugins/vmotif-demo.py"
    assert _code(port) == _code(ported) != _code(
        REPO / "vstree_tpu/plugins/vmotif-demo.py")


def test_supermax_copy_is_the_original_mesh_branch_included():
    """``engine/supermax.py`` is the original statement for statement,
    ``find_supermax``'s ``mesh`` branch included: the branch imports
    ``supermax_intervals_sharded`` from ``..parallel.shardesa``, which is
    the port's own under the same relative path.  No departure."""
    rel = "engine/supermax.py"
    assert _departures(rel) == (set(), set(), set())
    assert _code(REPO / "vstree_tpu_torch" / rel) == _code(
        REPO / "vstree_tpu" / rel)
    fn = _function(rel, "find_supermax", "vstree_tpu_torch")
    assert fn.args.args[-1].arg == "mesh"
    branch = fn.body[0]
    assert ast.unparse(branch.test) == "mesh is not None"
    assert ast.unparse(branch.body[0]) == (
        "from ..parallel.shardesa import supermax_intervals_sharded")


def _mesh_branch(fn: ast.AST) -> ast.If:
    """The ``if`` that selects a function's mesh path."""
    return next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                and "mesh is not None" in ast.unparse(n.test))


def _stripped(rel: str, name: str) -> ast.AST:
    """The port's function with its device and instrumentation taken
    out (``_without_device``), parsed again."""
    src = _without_device(_function(rel, name, "vstree_tpu_torch"))
    return ast.parse(src).body[0]


def test_build_mesh_branches_depart_in_the_device_and_the_lcp_pass():
    """The mesh paths of ``index/build.py``: ``suffix_sort``'s branch and
    ``lcp_table`` are the originals but for the device (``mesh`` is
    keyword-only in the port's ``suffix_sort``, whose ``sigma`` came
    first); ``build_esa``'s branch takes the lcp table right after the
    sharded sort (in phases "sharded sort" and "sharded lcp"), where the
    original takes it in its ``lcp`` and ``skp`` blocks; and
    ``lcp_from_pairs`` shares the original's opening and its monolithic
    branch, while its mesh path runs the windowed rounds as the shard
    program (a list of per-shard tensors, ``psum`` of the active counts,
    ``collect`` to the host) where the original lays one array out with
    ``flat_spec``."""
    rel = "index/build.py"
    port = _stripped(rel, "suffix_sort")
    orig = _function(rel, "suffix_sort", "vstree_tpu")
    assert ast.dump(_mesh_branch(port)) == ast.dump(_mesh_branch(orig))
    assert [a.arg for a in port.args.kwonlyargs] == ["mesh"]
    assert ast.unparse(_stripped(rel, "lcp_table")) == ast.unparse(
        _function(rel, "lcp_table", "vstree_tpu"))
    port = _mesh_branch(_stripped(rel, "build_esa"))
    orig = _mesh_branch(_function(rel, "build_esa", "vstree_tpu"))
    assert ast.unparse(port.test) == ast.unparse(orig.test)
    assert ast.dump(port.body[0]) == ast.dump(orig.body[0])
    assert [ast.unparse(st) for st in port.body[1:]] == [
        "if 'lcp' in demand or 'skp' in demand:\n"
        "    lcptab = lcp_table(text, suftab, mesh=mesh)"]
    assert "lcp_table(text, suftab, mesh=mesh)" in ast.unparse(
        _function(rel, "build_esa", "vstree_tpu"))
    port = _stripped(rel, "lcp_from_pairs")
    orig = _function(rel, "lcp_from_pairs", "vstree_tpu")
    assert [a.arg for a in port.args.args] == [a.arg for a in orig.args.args]
    for p, o in zip(port.body[:3], orig.body[:3]):
        assert ast.dump(p) == ast.dump(o)
    assert ast.unparse(port.body[3]) == (
        "if mesh is None:\n    from .sort import lce_pairs_host\n"
        "    return lce_pairs_host(text_np, a_np, b_np)")
    assert ast.unparse(orig.body[3]) == ast.unparse(port.body[3])
    source = ast.unparse(port)
    for same in ("mpad != m", "range(8)", "max(1024, m // 256)",
                 "min(4096, max(w, 256))", "_lcp_round(", "w2 * 2"):
        assert same in source and same in ast.unparse(orig), same


def test_complete_mesh_branch_departs_in_its_phase_only():
    """``exact_complete_matches(mesh=)``: the branch is the original's
    (``exact_interval_lookup_sharded`` from ``..parallel.shardesa``),
    timed as the phase "sharded lookup"."""
    rel = "engine/complete.py"
    port = _stripped(rel, "exact_complete_matches")
    orig = _function(rel, "exact_complete_matches", "vstree_tpu")
    assert port.args.args[-1].arg == orig.args.args[-1].arg == "mesh"
    assert ast.dump(_mesh_branch(port)) == ast.dump(_mesh_branch(orig))
    assert "phase('sharded lookup')" in ast.unparse(
        _function(rel, "exact_complete_matches", "vstree_tpu_torch"))


def _plan_init(pkg: str) -> list[str]:
    """The statements of ``RankLookupPlan.__init__`` but its imports,
    unparsed."""
    cls = _function("engine/complete.py", "RankLookupPlan", pkg)
    init = next(n for n in cls.body if getattr(n, "name", None)
                == "__init__")
    return [ast.unparse(st) for st in init.body
            if not isinstance(st, (ast.Import, ast.ImportFrom))]


def test_rank_lookup_plan_departs_in_the_tpu_guards():
    """``RankLookupPlan``: the port keeps the original's statements up to
    the coverage, so both take the same ppl, coverage, chars per word
    and sigma; it drops the two guards of the TPU kernel's bucket table,
    the window (``rowspan > 8``) and the 31-bit packing (``shift +
    bitlen(width) > 31``), and with them ``shift`` and ``rowspan``: K1
    reads an unpacked ``(left, width)`` table and takes any widest
    bucket.  Its ``ok`` keeps the coverage and alphabet tests and adds
    K1's own bound n < 2^30, checked before any table is made.  Where
    the JAX plan is ok both agree (``tests/test_torch_rank_guard.py``)."""
    port, orig = _plan_init("vstree_tpu_torch"), _plan_init("vstree_tpu")
    assert port[:8] == orig[:8]
    assert port[7] == "self.coverage = self.ppl + 2 * self.cpw"
    guards = [st for st in orig if "rowspan" in st or "maxw" in st]
    assert len(guards) == 3 and orig[8].startswith("self.shift = ")
    assert not any(w in st for st in port
                   for w in ("shift", "rowspan", "maxw"))
    ok_port = ast.parse(port[8]).body[0].value.values
    ok_orig = ast.parse(orig[9]).body[0].value.values
    assert [ast.dump(v) for v in ok_port[:2]] == [ast.dump(v)
                                                  for v in ok_orig[:2]]
    assert ast.unparse(ok_orig[2]) == "n >= 1"
    assert ast.unparse(ok_port[2]) == "1 <= n < MAX_N"
    assert port[9] == orig[10] == "if not self.ok:\n    return"
    assert port[10:] == ["self.bck = self._bracket_table()",
                         "self.suf = esa.device_suf32()",
                         "self.text = esa.device('text')"]


def _text():
    rng = np.random.default_rng(12)
    t = rng.integers(0, 4, 3000).astype(np.uint8)
    t[rng.choice(3000, 6, replace=False)] = 254
    t[[700, 1900]] = 255
    t[2200:2260] = t[300:360]
    return t


def _multiseq(cls, text):
    ms = cls(sequence=text.copy(), totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    ms.descriptions = [f"s{i}".encode() for i in range(ms.numofsequences)]
    return ms


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One JAX-built ESA written by the JAX package's write_index and,
    through ESA.from_shared, by the port's."""
    tmp = tmp_path_factory.mktemp("io")
    jesa = j_build_esa(_multiseq(JMultiseq, _text()), j_dna_alphabet(),
                       prefixlength=3,
                       demand=("suf", "lcp", "bwt", "bck", "sti", "skp"))
    jname, tname = str(tmp / "j"), str(tmp / "t")
    jio.write_index(jesa, jname)
    tio.write_index(ESA.from_shared(jesa, "cpu"), tname)
    return jesa, jname, tname


def test_write_index_same_bytes(written):
    _, jname, tname = written
    seen = 0
    for ext in EXTS:
        jp, tp = f"{jname}.{ext}", f"{tname}.{ext}"
        assert os.path.exists(jp) == os.path.exists(tp), ext
        if os.path.exists(jp):
            a, b = Path(jp).read_bytes(), Path(tp).read_bytes()
            if ext == "prj":  # the project file names its index
                a, b = a.replace(b"/j", b"/x"), b.replace(b"/t", b"/x")
            assert a == b, ext
            seen += 1
    assert seen >= 11


def test_read_index_same_tables(written):
    jesa, jname, tname = written
    want = jio.read_index(jname)
    for name in (jname, tname):
        got = tio.read_index(name)
        assert type(got) is ESA and got.dev is None
        for f in ("suftab", "lcptab", "bwttab", "bcktab", "stitab",
                  "skptab"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        for f in ("prefixlength", "longest", "maxbranchdepth",
                  "largelcpvalues", "totallength", "numofcodes"):
            assert getattr(got, f) == getattr(want, f), f
        np.testing.assert_array_equal(got.text, want.text)
        assert got.multiseq.numofsequences == want.multiseq.numofsequences
    read = ESA.read(tname, "cpu")
    assert str(read.dev) == "cpu"
    np.testing.assert_array_equal(read.device("suftab").numpy(),
                                  jesa.suftab)


def _table(cls, rng, n, total):
    tot = 40
    l1 = rng.integers(15, 30, tot)
    return cls(
        length1=l1.astype(np.int64),
        position1=rng.integers(0, total - 40, tot).astype(np.int64),
        length2=(l1 + rng.integers(-1, 2, tot)).astype(np.int64),
        position2=rng.integers(0, 500, tot).astype(np.int64),
        distance=rng.integers(-2, 3, tot).astype(np.int64),
        flag=np.full(tot, FLAGQUERY | FLAGCOMPLETEMATCH, np.int64),
        seqnum1=np.zeros(tot, np.int64), relpos1=np.zeros(tot, np.int64),
        seqnum2=rng.integers(0, 3, tot).astype(np.int64),
        relpos2=np.zeros(tot, np.int64), evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64))


@pytest.mark.parametrize("showmode", [0, jrender.SHOWABSOLUTE,
                                      jrender.SHOWNOEVALUE
                                      | jrender.SHOWNOSCORE])
def test_funnel_and_render_same_rows(showmode):
    """process_final and render_matches of the port on a table with
    distances of both signs: the same columns and the same lines."""
    text = _text()
    lines = []
    for (ms_cls, table_cls, fun, ren, ev_cls) in (
            (JMultiseq, JMatchTable, jfunnel, jrender, JEvalues),
            (Multiseq, MatchTable, tfunnel, trender, Evalues)):
        ms = _multiseq(ms_cls, text)
        qtext = text[:600].copy()
        qtext[[200, 400]] = 255
        query = _multiseq(ms_cls, qtext)
        mt = _table(table_cls, np.random.default_rng(3), 40, text.size)
        s1, r1 = ms.pos_to_pair(mt.position1)
        mt.seqnum1, mt.relpos1 = s1, r1
        mp = fun.MatchParams(leastlength=0, identity=0.0, leastscore=None,
                             maxevalue=None, lowergaplength=None,
                             uppergaplength=None)
        mt = fun.process_final(mt, ms, ev_cls(0.25), mp, query=query)
        digits = ren.assign_virtual_digits(ms)
        ren.assign_query_digits(digits, query)
        buf = io.StringIO()
        for line in ren.render_matches(mt, ms, digits, showmode, query):
            print(line, file=buf)
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and lines[0].count("\n") == 40


def test_envconf_copy_lacks_only_the_compile_cache():
    """``core/envconf.py`` holds ``check_env_on_off`` and
    ``scan_paths_for_file`` as the originals; the XLA compile cache has
    no counterpart."""
    gone, new, differ = _departures("core/envconf.py")
    assert gone == {"configure_compile_cache"}
    assert not new and not differ
    assert {"check_env_on_off", "scan_paths_for_file"} <= set(
        _statements(REPO / "vstree_tpu_torch/core/envconf.py"))


def _strings(*nodes) -> set[str]:
    return {n.value for node in nodes for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_vmatch_entry_departs_from_the_jax_main_where_named():
    """The port's ``entry`` (with ``_check_queryspeedup``, and ``main``,
    which passes it the CUDA card) does what the JAX CLI's ``main`` does
    in the same order: the QUERYSPEEDUP check with its messages, the
    on/off checks, the trace inside the timing mode, the same two timing
    lines, exit 0 on a broken pipe.  Its departures: the device, which
    is asked for after the checks; torch.profiler in place of
    jax.profiler; no ``UNAVAILABLE`` retry; VSTREE_DEBUG_NANS=on arms
    nothing."""
    rel = "cli/vmatch.py"
    jmain = _function(rel, "main", "vstree_tpu")
    check, entry, tmain = (_function(rel, name, "vstree_tpu_torch")
                           for name in ("_check_queryspeedup", "entry",
                                        "main"))
    assert _strings(jmain) - _strings(check, entry, tmain) == {
        "UNAVAILABLE", "jax", "jax_debug_nans", "os",
        "vmatch: transient device fault, retrying once"}
    assert _strings(check, entry, tmain) - _strings(jmain) == {
        "cuda", "vmatch"}
    assert ast.unparse(tmain.body) == (
        "entry(sys.argv[1:], cuda_device, cuda_devices)")
    body = [ast.unparse(st) for st in entry.body]
    assert body[:5] == [
        "_check_queryspeedup()",
        "showtimespace = check_env_on_off('VMATCHSHOWTIMESPACE')",
        "profile_dir = os.environ.get('VSTREE_PROFILE')",
        "check_env_on_off('VSTREE_DEBUG_NANS')",
        "dev, devs = (device(), devices())"]
    source = ast.unparse(entry)
    jsource = ast.unparse(jmain)
    for same in ("print(f'# TIME vmatch {time.process_time() - t0:.2f}')",
                 "print(f'# SPACE vmatch {peak:.2f}')",
                 "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / "
                 "1024.0", "except BrokenPipeError:\n        sys.exit(0)"):
        assert same in source and same in jsource, same
    assert "torch.profiler.profile(" in source
    assert "tensorboard_trace_handler(profile_dir, worker_name='vmatch')" \
        in source
    assert "except Exception" not in source and "retry" not in source
