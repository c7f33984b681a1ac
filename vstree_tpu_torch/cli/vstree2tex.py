"""vstree2tex: LaTeX dump of an index (reference
Mkvtree/vstree2tex.c -> readvirt.c:1100 ``virtual2tex``).

Supported tables: -ois -tis -suf -lcp -skp -bwt -sti -sti1 -bck
[-bckhz] and -s (suffix strings); the experimental cld/iso/lsf/cfr/crf
tables are not part of this framework's index family.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.chardef import SEPARATOR
from ..index.io import read_index

OIS, TIS, SUF, LCP, SKP, BWT, STI, STI1, BCK = (1 << i
                                                for i in range(9))

_OPTS = {
    "-ois": OIS, "-tis": TIS, "-suf": SUF, "-lcp": LCP, "-skp": SKP,
    "-bwt": BWT, "-sti": STI, "-sti1": STI1, "-bck": BCK,
}
# (bit, LaTeX macro name) in the reference's fixed column order
_ORDER = [
    (OIS, "OIS"), (TIS, "TIS"), (SUF, "SUF"), (LCP, "LCP"),
    (SKP, "SKP"), (BWT, "BWT"), (STI, "STI"), (STI1, "STITABone"),
]


def _sepnum(seq: np.ndarray, i: int) -> int:
    return int((seq[:i] == SEPARATOR).sum())


def _texchar(seq: np.ndarray, n: int, characters, i: int) -> str:
    c = int(seq[i]) if i < seq.size else None
    if c == SEPARATOR:
        return str(_sepnum(seq, i))
    if i == n:
        return " "
    return chr(int(characters[c]))


def _code2string(code: int, numofchars: int, prefixlen: int,
                 characters) -> str:
    out = [""] * prefixlen
    for i in range(prefixlen - 1, -1, -1):
        cc = code % numofchars
        out[i] = chr(int(characters[cc]))
        code //= numofchars
    return "".join(out)


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    which = 0
    bckhz = False
    showstring = False
    indexname = None
    for a in argv:
        if a == "-s":
            showstring = True
        elif a == "-bckhz":
            which |= BCK
            bckhz = True
        elif a in _OPTS:
            which |= _OPTS[a]
        elif a.startswith("-"):
            raise SystemExit(
                f"vstree2tex: unsupported option {a} (experimental "
                "tables are not part of this index family)")
        else:
            indexname = a
    if indexname is None:
        raise SystemExit("Usage: vstree2tex options indexname")

    esa = read_index(indexname)
    ms = esa.multiseq
    n = int(ms.totallength)
    alpha = esa.alpha
    chars = alpha.characters
    w = out.write

    w("\\documentclass[12pt]{article}\n")
    for bit, name in _ORDER:
        if which & bit:
            if bit == STI1:
                w("\\newcommand{\\STITABone}[0]{\\mathsf{STI1}}\n")
            else:
                w(f"\\newcommand{{\\{name}}}[0]"
                  f"{{\\mathsf{{{name}}}}}\n")
    if which & BCK:
        w("\\newcommand{\\BCK}[0]{\\mathsf{BCK}}\n")
    if showstring and not (which & SUF):
        w("\\newcommand{\\SUF}[0]{\\mathsf{SUF}}\n")
    w("\\begin{document}\n")

    numoftabs = sum(1 for bit, _ in _ORDER if which & bit)
    if showstring:
        numoftabs += 1

    w("\\[\n")
    if numoftabs > 0:
        w(" \\begin{array}[t]{*{%lu}{|r}|%c|}\\hline\n i"
          % (numoftabs, "l" if showstring else "r"))
        for bit, name in _ORDER:
            if which & bit:
                w(" &\\%s" % ("STITABone" if bit == STI1
                              else name[:3]))
        if showstring:
            w(" &S_{\\SUF[i]}")
        w(" \\\\\\hline\\hline\n")
        suftab = esa.suftab
        lcptab = esa.lcptab
        if which & STI1:
            from ..index.io import sti1_table

            sti1 = sti1_table(esa.suftab, esa.lcptab,
                              esa.prefixlength)
        for i in range(n + 1):
            w(" %d" % i)
            if which & OIS:
                oseq = ms.originalsequence
                w(" &")
                c = int(oseq[i]) if i < oseq.size else None
                if c == SEPARATOR:
                    w(str(_sepnum(oseq, i)))
                elif i == n:
                    w(" ")
                else:
                    w(chr(c))
            if which & TIS:
                w(" &" + _texchar(ms.sequence, n, chars, i))
            if which & SUF:
                w(" &%d" % suftab[i])
            if which & LCP:
                w(" &      " if i == 0 else " &%d" % lcptab[i])
            if which & SKP:
                w(" &%d" % (1 + esa.skptab[i]))
            if which & BWT:
                if esa.longest == i:
                    w(" &          ")
                else:
                    w(" &\\texttt{"
                      + _texchar(ms.sequence, n, chars,
                                 int(suftab[i]) - 1) + "}")
            if which & STI:
                w(" &%d" % esa.stitab[i])
            if which & STI1:
                w(" &%d" % sti1[i])
            if showstring:
                reallen = n - int(suftab[i])
                showlen = reallen
                if showlen > 10:
                    maxlcp = int(lcptab[i])
                    if i < n and int(lcptab[i + 1]) > maxlcp:
                        maxlcp = int(lcptab[i + 1])
                    if showlen > maxlcp:
                        showlen = maxlcp + 1
                w(" &\\texttt{")
                for j in range(int(suftab[i]),
                               int(suftab[i]) + showlen):
                    w(_texchar(ms.sequence, n, chars, j))
                if showlen == reallen:
                    w("\\symbol{36}}\n")
                else:
                    w("...}\n")
            w(" \\\\\\hline\n")
        w(" \\end{array}\n")

    if which & BCK:
        if numoftabs > 0:
            w("&")
        bck = esa.bcktab
        numofcodes = bck.size // 2
        sigma = alpha.mapsize - 1
        pl = esa.prefixlength
        if bckhz:
            w(" \\begin{array}{|l*{%lu}{|c}|}\\hline\n" % numofcodes)
            w(" w&")
            for i in range(numofcodes):
                w(" \\texttt{" + _code2string(i, sigma, pl, chars)
                  + "}")
                w("\\\\\\hline\n" if i == numofcodes - 1 else "&")
            w("\\BCK[\\varphi(w)]&")
            for i in range(numofcodes):
                left, mid = int(bck[2 * i]), int(bck[2 * i + 1])
                w(f"({left},{mid - 1})" if mid > left else "(1,0)")
                w(" \\\\\\hline\n" if i == numofcodes - 1 else "&")
        else:
            w(" \\begin{array}[t]{|l|c|}\\hline\n")
            w(" w&\\BCK[\\varphi(w)]\\\\\\hline\\hline\n")
            for i in range(numofcodes):
                w(" \\texttt{" + _code2string(i, sigma, pl, chars)
                  + "}&")
                left, mid = int(bck[2 * i]), int(bck[2 * i + 1])
                w(f"({left},{mid - 1})" if mid > left else "(1,0)")
                w(" \\\\\\hline\n")
        w(" \\end{array}\n")
    w("\\]\n\\end{document}\n")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
