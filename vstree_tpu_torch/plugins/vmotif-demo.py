"""Demo vplugin (the vmotif family): IUPAC motif search, the port's copy
of ``vstree_tpu/plugins/vmotif-demo.py`` (it imports the port's engine).

The Python analog of the reference's vmotif shared-object plugins
(Vmatch/vmotif-start.c + vmotif-demo.c): passed to ``-complete`` as
``vmotif-demo.py``, it takes over the search, expands an IUPAC motif
(from the plugin argument list, default "RGATCY") into its concrete
DNA words, locates every occurrence with the framework's exact
interval lookup, and hands the matches to the standard funnel.

Usage:
    vmatch -complete /path/to/vmotif-demo.py -selfun x RGGTCA idx
    (plugin args ride the -selfun argument list; any motif over
    ACGTRYSWKMBDHVN)
"""

import numpy as np

IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def vplugininit(data):
    data.state["motif"] = (data.plugin_args[0].upper()
                           if data.plugin_args else "RGATCY")


def vpluginadddemand(data):
    data.demand.update({"suf", "bck"})


def vpluginparse(data):
    motif = data.state["motif"]
    bad = [c for c in motif if c not in IUPAC]
    if bad:
        raise SystemExit(
            f"vmotif-demo: illegal IUPAC symbol(s) {bad} in {motif!r}")
    words = [[]]
    for c in motif:
        words = [w + [CODE[x]] for w in words for x in IUPAC[c]]
    data.state["words"] = [np.array(w, np.uint8) for w in words]


def vpluginsearch(data):
    from vstree_tpu_torch.engine.complete import exact_complete_matches

    words = data.state["words"]
    mt = exact_complete_matches(data.esa, words)
    data.process(mt)


def vpluginwrap(data):
    data.state.clear()
