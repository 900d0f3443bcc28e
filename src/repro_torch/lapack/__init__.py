"""repro_torch.lapack - blocked Cholesky, LU and the LU solve (port of
``repro.lapack``; QR, least squares and the batched drivers are later
work)."""
