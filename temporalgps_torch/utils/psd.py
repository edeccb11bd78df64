"""Covariance helpers (temporalgps_tpu/utils/psd.py, the part this port uses)."""


def symmetrize(P):
    """0.5 (P + P^T) on the trailing two axes."""
    return 0.5 * (P + P.transpose(-1, -2))
