"""Numeric kernels and containers: host CSR, device DIA + CSR matrix, SpMV kernels, vectors."""
