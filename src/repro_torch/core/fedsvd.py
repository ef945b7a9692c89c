"""FedSVD (Chai et al., KDD'22): lossless federated SVD over vertically
partitioned data via random orthogonal masking, the representation-learning
stage of VFedTrans.  A copy of ``repro.core.fedsvd``: the same host numpy
stream (``np.random.RandomState(seed)``), the same signed permutations and
the same ``np.linalg.svd``, so U, S and the channel's bytes are the
reference's bits.  The trusted server is a host in the protocol, so the
SVD stays on the host whatever device the rest of a run uses.

Protocol (and the paper's Appendix-E comm accounting):
  keygen -> parties:  A (n x n), B_t / B_d slices of orthogonal B
  party k -> server:  S~_k = A X_k B_k
  server:             X' = sum_k S~_k ;  SVD(X') = U' S V'^T
  server -> active:   U~ = U' (masked left factors)
  active:             U = A^T U'   (lossless since A, B orthogonal)

A dense random-orthogonal A (n x n) costs O(n^3); a signed permutation is
exactly orthogonal at O(n).  The byte accounting is unchanged (A ships as
a dense n x n matrix per Eq. 10), and so is the algebra.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import comm


@dataclass
class FedSVDResult:
    U: np.ndarray            # (n, r) federated left factors (active's copy)
    S: np.ndarray            # (r,) singular values
    channel: comm.Channel
    rounds: int


def _signed_perm(n: int, rng) -> tuple:
    perm = rng.permutation(n)
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return perm, sign


def _apply_A(perm, sign, X):          # A @ X  with A = P diag(sign)
    return (X * sign[:, None])[perm]


def _apply_AT(perm, sign, X):
    # A[i,j] = sign[j]*[j == perm[i]]  =>  (A^T Y)[i] = sign[i]*Y[perm^-1(i)]
    return X[np.argsort(perm)] * sign[:, None]


def fedsvd(x_active: np.ndarray, x_passive: np.ndarray, *, seed: int = 0,
           channel: comm.Channel | None = None) -> FedSVDResult:
    """x_active (n, x_t), x_passive (n, x_d): the ALIGNED rows of each
    party, as host arrays."""
    n, x_t = x_active.shape
    x_d = x_passive.shape[1]
    x_tot = x_t + x_d
    rng = np.random.RandomState(seed)
    channel = channel or comm.Channel()

    # trusted key generator
    permA, signA = _signed_perm(n, rng)
    permB, signB = _signed_perm(x_tot, rng)
    channel.send("fedsvd/keygen->active: A,B_t", (n * n + x_t * x_tot) * 4,
                 direction="downlink")
    channel.send("fedsvd/keygen->passive: A,B_d", (n * n + x_d * x_tot) * 4,
                 direction="downlink")

    # masked uploads: S~_k = A X_k B_k   (B_k = rows of B for party k's cols)
    def mask_party(Xk, col_offset, ncols):
        AX = _apply_A(permA, signA, Xk.astype(np.float32))
        S = np.zeros((n, x_tot), np.float32)
        # B = P_B diag(signB): column j of global X lands in column permB[j]
        for j in range(ncols):
            gj = col_offset + j
            S[:, permB[gj]] = AX[:, j] * signB[permB[gj]]
        return S

    St = mask_party(x_active, 0, x_t)
    Sd = mask_party(x_passive, x_t, x_d)
    channel.send("fedsvd/active->server: S~_t", n * x_t * 4,
                 direction="uplink")
    channel.send("fedsvd/passive->server: S~_d", n * x_d * 4,
                 direction="uplink")

    Xp = St + Sd
    Up, S, _ = np.linalg.svd(Xp, full_matrices=False)
    channel.send("fedsvd/server->active: U~", n * x_tot * 4,
                 direction="downlink")

    U = _apply_AT(permA, signA, Up)
    return FedSVDResult(U.astype(np.float32), S.astype(np.float32),
                        channel, comm.VFEDTRANS_ROUNDS)
