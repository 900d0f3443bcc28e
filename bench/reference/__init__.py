"""Plain references, one module per LAPACK driver that a traffic mix
names (``routine``: ``posv``, ``gels``), each in plain PyTorch: it
imports nothing of the port and takes nothing the port made. Each module
gives

- ``flops(m, n, nrhs)``: LAWN 41's leading-order count of one item
  (Blackford and Dongarra, "Installation guide for LAPACK", LAPACK
  Working Note 41, appendix: operation counts; multiplications plus
  additions), a fixed yardstick of the work a request asks for and not
  the flops the program executes;
- ``items(rand, batch, m, n, traffic)``: the driver's kind of item, made
  from the Gaussian source ``rand`` of ``bench/generate.py``;
- ``factor(a, tf32=False)``: the factorization of a (B, m, n) batch in
  the port's packed layout, as a dict (``factors``, and ``tau`` for QR);
- ``solve(fact, b, tf32=False)``: the solution of every item;
- ``factor_numbers(ref, got)``: the worst item's relative gaps between
  the program's factorization ``got`` and the reference's ``ref``.

Run in float64 they are the reference; run in float32 with ``tf32=True``
(matrix products in TF32) they are the control, the step below the
float32 that the configurations state. A new driver is one new module.
"""
