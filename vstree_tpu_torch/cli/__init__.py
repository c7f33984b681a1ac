"""Entry points of the port, each ``python -m vstree_tpu_torch.cli.<tool>``.

Tools that do device work take the device in ``run(argv, device)`` and
ask for the CUDA card in ``main()``: ``mkvtree``, ``vmatch``,
``chainqhits``, ``mkcfr``, ``mkrcidx``, ``mkdna6idx`` and ``repfind``.
Tools that only read an index or a match file are host code with the
JAX package's ``run(argv[, out])``: ``vmatchselect``, ``chain2dim``,
``matchcluster``, ``vseqinfo``, ``vseqselect``, ``vsubseqselect``,
``vendian``, ``vstree2tex``, ``mksti``, ``mkiso``, ``mklsf``,
``mkvcmp`` and ``mkcld``."""
