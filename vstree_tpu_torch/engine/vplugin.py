"""Generic vplugin protocol (reference vplugin-interface.h:37-52).

The reference's second plugin ABI: a shared object named
``vmotif*``/``cpridx*`` passed to ``-complete`` takes over the whole
search with five hooks (init, adddemand, parse, search, wrap) and full
access to the index, the query files and the match funnel
(Vmatch/vplugin-open.c, vmotif-start.c, cpridx-start.c).  The analog
here is a Python module with the same five hooks and the same
takeover semantics:

    def vplugininit(data): ...       # set up plugin state
    def vpluginadddemand(data): ...  # extend data.demand (index tables)
    def vpluginparse(data): ...      # consume data.plugin_args
    def vpluginsearch(data): ...     # run; call data.process(MatchTable)
    def vpluginwrap(data): ...       # tear down

``data`` carries the open ESA, the query file list/Multiseq, the
program/index names, the online flag, free-form ``state`` storage and
``process`` — the funnel callback that runs every emitted MatchTable
through the standard filter/output pipeline (the processfinal handle
the reference passes in vmotif-start.c:23).  All five hooks are
mandatory, as in the reference's interface-struct check
(VPLUGINCHECKSIZES).
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field

_HOOKS = ("vplugininit", "vpluginadddemand", "vpluginparse",
          "vpluginsearch", "vpluginwrap")

# WORKPREFIXes of the two plugin families (parsevm.c:1148-1161)
PREFIXES = ("vmotif", "cpridxps")


@dataclass
class VpluginData:
    """The per-run data handed to every hook (Vmotifdata analog,
    Vmatch/vmotif-data.h)."""
    progname: str
    indexname: str
    esa: object
    queryfiles: list
    query: object            # parsed query Multiseq or None
    forceonline: bool
    plugin_args: list
    process: object          # callable(MatchTable) -> None
    demand: set = field(default_factory=set)
    state: dict = field(default_factory=dict)


def is_vplugin_arg(arg: str) -> bool:
    base = os.path.basename(arg)
    return any(base.startswith(p) for p in PREFIXES)


def open_vplugin(path: str):
    """Load the plugin module and return its five hooks (all are
    mandatory, mirroring the reference's interface completeness
    check)."""
    spec = importlib.util.spec_from_file_location("vmatch_vplugin",
                                                  path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"vmatch: cannot load vplugin {path!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    hooks = []
    for name in _HOOKS:
        fn = getattr(module, name, None)
        if fn is None:
            raise SystemExit(
                f"vmatch: vplugin {path!r} does not define the "
                f"mandatory hook {name!r} "
                "(vplugin-interface.h:30-43)")
        hooks.append(fn)
    return tuple(hooks)


def run_vplugin(path: str, data: VpluginData) -> None:
    """Hook sequence of the reference driver: init -> adddemand ->
    parse -> search -> wrap."""
    init, adddemand, parse, search, wrap = open_vplugin(path)
    for hook in (init, adddemand, parse, search, wrap):
        rc = hook(data)
        if rc not in (None, 0):
            raise SystemExit(
                f"vmatch: vplugin hook {hook.__name__} failed "
                f"({rc})")
