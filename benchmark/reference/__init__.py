"""The plain float64 NumPy reference that decides ``correct``.

A frozen copy of the repository's float64 oracles (each module's header
names the file and the commit it was copied from), written against an
:class:`~benchmark.reference.arith.Arith` so that the same code also runs
as the lower-precision control. It imports NumPy only: nothing of the
program, of the JAX package or of JAX (``benchmark/tests`` checks this).
"""
