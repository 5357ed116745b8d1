"""Plain reference of the ellipse covariance applied as the zero-storage
stream, in float64: ``reference/ellipse.py``'s Paciorek-Schervish
covariance (``Fields``), whose haversine cutoff runs over every column of
every row (no band, no certificate), and its factored kriging and
ensemble (``lowrank``).

At 259,200 cells C is 6.7e10 entries, so each compared variant passes
over C's rows once, in blocks of ``ROWS``, for all of its compared
columns at once (``product``): the stream's first block, and the clip's
retained vectors.
"""

import torch

from .ellipse import Fields, lowrank

__all__ = ["Fields", "lowrank", "product"]

# rows of C a block: ~a dozen (ROWS, n) float64 temporaries, 6.4 GB at
# 259,200 cells
ROWS = 256


def product(fields, X, nu, rows=ROWS):
    """C @ X for X (n, k), in float64, in one pass over C's rows; TF32
    off (float64 products do not use it; set so that nothing else
    does)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fields.apply(X, nu, rows=rows)
