"""XML match output (-s xml).

Reference: Vmatch/xmlfunc.c:1-326 (vmatchxmlheader / vmatchxmlinit /
vmatchxmlmatch / vmatchxmlwrap; 2-space indent per level,
include/xmlindent.h) and kurtz/showalign.c showeditopsgeneric (the
<DNA_eops> alignment block with consecutive same-type edit operations
merged).  Quirks reproduced verbatim: Vmatchrelpos1 is printed twice
per match (xmlfunc.c:258/299), descriptions print with
replaceblanks=False (echomatch.c:1040).
"""

from __future__ import annotations

import numpy as np

from ..core.multiseq import Multiseq
from .align import (
    DELETIONEOP,
    INSERTIONEOP,
    MAXIDENTICALLENGTH,
    MISMATCHEOP,
)

_IND = "  "


def xml_header(argv: list[str], out) -> None:
    """vmatchxmlheader (xmlfunc.c:107-126)."""
    out.write('<?xml version="1.0"?>\n')
    out.write('<!DOCTYPE Vmatchoutput PUBLIC "-//VMATCH//VMATCH '
              'Vmatchoutput/EN" "Vmatchoutput.dtd">\n')
    out.write("<Vmatchoutput>\n")
    out.write(_IND + "<Vmatchglobalparams>\n")
    out.write(_IND * 2 + f"<Vmatchindex>{argv[-1]}</Vmatchindex>\n")
    # query files: the args following "-q" up to the next option
    inq = False
    for i, a in enumerate(argv):
        if inq:
            if i == len(argv) - 1 or a.startswith("-"):
                break
            out.write(_IND * 2
                      + f"<Vmatchquery>{a}</Vmatchquery>\n")
        elif a == "-q":
            inq = True


def xml_init(alpha, vms: Multiseq, qms: Multiseq | None, out) -> None:
    """vmatchxmlinit + vmatchxmlalphabet (xmlfunc.c:128-199)."""
    w = out.write
    w(_IND * 2 + f"<Vmatchnumofdbseq>{vms.num_db_sequences}"
      "</Vmatchnumofdbseq>\n")
    # DATABASELENGTH subtracts the separator slot unconditionally
    # (multidef.h:91-92)
    dblen = vms.totallength - vms.totalquerylength - 1
    w(_IND * 2 + f"<Vmatchdatabaselength>{dblen}"
      "</Vmatchdatabaselength>\n")
    if qms is not None:
        w(_IND * 2 + f"<Vmatchnumofqueryseq>{qms.num_db_sequences}"
          "</Vmatchnumofqueryseq>\n")
        qlen = qms.totallength - qms.totalquerylength - 1
        w(_IND * 2 + f"<Vmatchquerylength>{qlen}"
          "</Vmatchquerylength>\n")
    w(_IND * 2 + "<Vmatchalphabet>\n")
    w(_IND * 3 + f"<Vmatchalphabetdomainsize>{alpha.domainsize}"
      "</Vmatchalphabetdomainsize>\n")
    w(_IND * 3 + f"<Vmatchalphabetmapsize>{alpha.mapsize}"
      "</Vmatchalphabetmapsize>\n")
    w(_IND * 3 + "<Vmatchalphabetmappedwildcards>"
      f"{alpha.mappedwildcards}</Vmatchalphabetmappedwildcards>\n")
    w(_IND * 3 + f"<Vmatchalphabetundefsymbol>{alpha.undefsymbol}"
      "</Vmatchalphabetundefsymbol>\n")
    dom = alpha.mapdomain.decode("latin1")
    w(_IND * 3 + f"<Vmatchalphabetdomain>{dom}"
      "</Vmatchalphabetdomain>\n")
    verbose = bytes(alpha.characters[: alpha.mapsize]).decode("latin1")
    w(_IND * 3 + f"<Vmatchalphabetverbosechar>{verbose}"
      "</Vmatchalphabetverbosechar>\n")
    w(_IND * 3 + "<Vmatchalphabetsymbolmap>\n")
    for ch in dom:
        code = int(alpha.symbolmap[ord(ch)])
        if code != alpha.undefsymbol:
            w(_IND * 4 + f"<Vmatchalphabetsymbolmapfrom>{ch}"
              "</Vmatchalphabetsymbolmapfrom>\n")
            w(_IND * 4 + f"<Vmatchalphabetsymbolmapto>{code}"
              "</Vmatchalphabetsymbolmapto>\n")
    w(_IND * 3 + "</Vmatchalphabetsymbolmap>\n")
    w(_IND * 2 + "</Vmatchalphabet>\n")
    w(_IND + "</Vmatchglobalparams>\n")
    w(_IND + "<Vmatchiterationmatches>\n")


def _eop_type(eop: int) -> str:
    if eop & MAXIDENTICALLENGTH:
        return "match" if (eop & ~MAXIDENTICALLENGTH) == 0 else "intron"
    if eop == MISMATCHEOP:
        return "mismatch"
    if eop == DELETIONEOP:
        return "deletion"
    if eop == INSERTIONEOP:
        return "insertion"
    raise ValueError(f"illegal edit operation {eop}")


def _eop_length(eop: int) -> int:
    if eop & MAXIDENTICALLENGTH:
        return eop & MAXIDENTICALLENGTH
    return 1


def xml_eops(eops: list[int], out) -> None:
    """showeditopinxml -> showeditopsgeneric (showalign.c:376-431):
    right-to-left eops consumed from the end, consecutive same-type
    operations merged."""
    w = out.write
    w(_IND * 3 + "<DNA_eops>\n")
    run_len = 0
    for i in range(len(eops) - 1, -1, -1):
        eop = eops[i]
        if i > 0 and _eop_type(eop) == _eop_type(eops[i - 1]):
            run_len += _eop_length(eop)
            continue
        total = run_len + _eop_length(eop)
        run_len = 0
        w(_IND * 4 + f"<DNA_eop_type>{_eop_type(eop)}"
          "</DNA_eop_type>\n")
        w(_IND * 4 + f"<DNA_eop_length>{total}</DNA_eop_length>\n")
    w(_IND * 3 + "</DNA_eops>\n")


def xml_match(row: dict, modechar: str, eops: list[int], out,
              desc1: str | None = None,
              desc2: str | None = None) -> None:
    """vmatchxmlmatch (xmlfunc.c:236-311) + the eops block +
    closeMatchtag."""
    w = out.write
    w(_IND * 2 + "<Match>\n")
    w(_IND * 3 + f"<Vmatchmatchidnumber>{row['idnumber']}"
      "</Vmatchmatchidnumber>\n")
    w(_IND * 3 + f"<Vmatchlength1>{row['length1']}"
      "</Vmatchlength1>\n")
    w(_IND * 3 + f"<Vmatchseqnum1>{row['seqnum1']}"
      "</Vmatchseqnum1>\n")
    if desc1 is not None:
        w(_IND * 3 + f"<Vmatchdescription1>{desc1}"
          "</Vmatchdescription1>\n")
    w(_IND * 3 + f"<Vmatchrelpos1>{row['relpos1']}"
      "</Vmatchrelpos1>\n")
    w(_IND * 3 + f"<Vmatchflag>{modechar}</Vmatchflag>\n")
    w(_IND * 3 + f"<Vmatchlength2>{row['length2']}"
      "</Vmatchlength2>\n")
    w(_IND * 3 + f"<Vmatchseqnum2>{row['seqnum2']}"
      "</Vmatchseqnum2>\n")
    if desc2 is not None:
        w(_IND * 3 + f"<Vmatchdescription2>{desc2}"
          "</Vmatchdescription2>\n")
    # the reference prints Vmatchrelpos1 again here (xmlfunc.c:299)
    w(_IND * 3 + f"<Vmatchrelpos1>{row['relpos1']}"
      "</Vmatchrelpos1>\n")
    w(_IND * 3 + f"<Vmatchrelpos2>{row['relpos2']}"
      "</Vmatchrelpos2>\n")
    w(_IND * 3 + f"<Vmatchdistance>{row['distance']}"
      "</Vmatchdistance>\n")
    w(_IND * 3 + f"<Vmatchevalue>{row['evalue']:.2e}"
      "</Vmatchevalue>\n")
    w(_IND * 3 + f"<Vmatchscore>{row['score']}</Vmatchscore>\n")
    w(_IND * 3 + f"<Vmatchidentity>{row['identity']:.2f}"
      "</Vmatchidentity>\n")
    xml_eops(eops, out)
    w(_IND * 2 + "</Match>\n")


def xml_wrap(out) -> None:
    out.write(_IND + "</Vmatchiterationmatches>\n")
    out.write("</Vmatchoutput>\n")
