"""Secure aggregation: finite-field MPC primitives (TurboAggregate), a copy
of ``fedml_tpu/algorithms/turboaggregate.py`` (bitwise equal for the same
arguments and seeds). The protocol that runs them between parties
(``turboaggregate_dist``) waits for the comm layer, ROADMAP §A11.

Reference: fedml_api/distributed/turboaggregate/mpc_function.py (275 LoC of
field math): modular inverse (:62), Lagrange coefficients, BGW secret-sharing
encode/decode (:62-110), Lagrange Coded Computing encode/decode (:111-262),
additive secret shares (:214), DH-style key agreement (:263-275).

The math is integer/finite-field — implemented here with int64 numpy (the
field prime fits 32 bits, products fit 64) plus vectorized polynomial
evaluation. These run host-side: secure aggregation is a *protocol* between
distrusting parties, so it lives in the comm layer, not inside a jit program.
A quantize/dequantize pair maps float model deltas into the field.
"""

from __future__ import annotations

import numpy as np

DEFAULT_PRIME = 2**31 - 1  # Mersenne prime; products fit in int64


def modular_inverse(a: int | np.ndarray, p: int = DEFAULT_PRIME):
    """a^(p-2) mod p by fast exponentiation (Fermat; reference divmod:62)."""
    a = np.asarray(a, dtype=np.int64) % p
    result = np.ones_like(a)
    exp = p - 2
    base = a.copy()
    while exp:
        if exp & 1:
            result = (result * base) % p
        base = (base * base) % p
        exp >>= 1
    return result


def _poly_eval(coeffs: np.ndarray, xs: np.ndarray, p: int) -> np.ndarray:
    """Horner evaluation of D polynomials at each x. coeffs [T, D], xs [N]
    -> [N, D], all mod p."""
    out = np.zeros((len(xs), coeffs.shape[1]), dtype=np.int64)
    for c in coeffs[::-1]:
        out = (out * xs[:, None] + c[None, :]) % p
    return out


def bgw_encode(secret: np.ndarray, n_shares: int, threshold: int,
               p: int = DEFAULT_PRIME, seed: int | None = None) -> np.ndarray:
    """Shamir/BGW secret sharing: secret [D] ints -> shares [N, D]
    (mpc_function.py BGW_encoding). Any threshold+1 shares reconstruct."""
    rng = np.random.RandomState(seed)
    secret = np.asarray(secret, dtype=np.int64).reshape(1, -1) % p
    coeffs = np.concatenate(
        [secret, rng.randint(0, p, (threshold, secret.shape[1])).astype(np.int64)]
    )
    xs = np.arange(1, n_shares + 1, dtype=np.int64)
    return _poly_eval(coeffs, xs, p)


def lagrange_coefficients(eval_points: np.ndarray, target: int = 0,
                          p: int = DEFAULT_PRIME) -> np.ndarray:
    """ℓ_i(target) for interpolation through eval_points (gen_Lagrange_coeffs)."""
    pts = np.asarray(eval_points, dtype=np.int64) % p
    coeffs = np.ones(len(pts), dtype=np.int64)
    for i in range(len(pts)):
        num, den = 1, 1
        for j in range(len(pts)):
            if i == j:
                continue
            num = (num * ((target - pts[j]) % p)) % p
            den = (den * ((pts[i] - pts[j]) % p)) % p
        coeffs[i] = (num * int(modular_inverse(den, p))) % p
    return coeffs


def bgw_decode(shares: np.ndarray, share_idx: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Reconstruct secret from shares [K, D] held at x = share_idx+1
    (BGW_decoding)."""
    xs = np.asarray(share_idx, dtype=np.int64) + 1
    lam = lagrange_coefficients(xs, 0, p)
    # reduce each product mod p before summing: lam_i * s_i < p^2 fits int64,
    # but a sum of >= 3 unreduced products overflows and wraps silently
    return (lam[:, None] * (np.asarray(shares, np.int64) % p) % p).sum(axis=0) % p


def lcc_encode(data: np.ndarray, n_workers: int, k_batches: int, t_privacy: int = 0,
               p: int = DEFAULT_PRIME, seed: int | None = None) -> np.ndarray:
    """Lagrange Coded Computing encode (LCC_encoding_w_Random):
    data [K, D] batches -> coded shares [N, D] along the polynomial through
    interpolation points 1..K(+T noise points), evaluated at K+T+1..K+T+N."""
    rng = np.random.RandomState(seed)
    data = np.asarray(data, dtype=np.int64) % p
    K, D = data.shape
    if t_privacy:
        noise = rng.randint(0, p, (t_privacy, D)).astype(np.int64)
        data = np.concatenate([data, noise])
    alpha = np.arange(1, K + t_privacy + 1, dtype=np.int64)  # interpolation pts
    beta = np.arange(K + t_privacy + 1, K + t_privacy + 1 + n_workers, dtype=np.int64)
    shares = np.zeros((n_workers, D), dtype=np.int64)
    for w, b in enumerate(beta):
        lam = lagrange_coefficients(alpha, int(b), p)
        shares[w] = (lam[:, None] * data % p).sum(axis=0) % p
    return shares


def lcc_decode(shares: np.ndarray, worker_idx: np.ndarray, k_batches: int,
               t_privacy: int = 0, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Recover the K data batches from >= K+T shares (LCC_decoding)."""
    beta = np.asarray(worker_idx, dtype=np.int64) + k_batches + t_privacy + 1
    out = np.zeros((k_batches, shares.shape[1]), dtype=np.int64)
    for target in range(1, k_batches + 1):
        lam = lagrange_coefficients(beta, target, p)
        out[target - 1] = (
            lam[:, None] * (np.asarray(shares, np.int64) % p) % p
        ).sum(axis=0) % p
    return out


def additive_shares(secret: np.ndarray, n: int, p: int = DEFAULT_PRIME,
                    seed: int | None = None) -> np.ndarray:
    """n additive shares summing to secret mod p (my_pk_gen / :214)."""
    rng = np.random.RandomState(seed)
    secret = np.asarray(secret, dtype=np.int64) % p
    shares = rng.randint(0, p, (n - 1,) + secret.shape).astype(np.int64)
    last = (secret - shares.sum(axis=0)) % p
    return np.concatenate([shares, last[None]])


def dh_keygen(generator: int, private: int, p: int = DEFAULT_PRIME) -> int:
    """Public key g^sk mod p (mpc_function.py:263-275)."""
    return pow(generator, private, p)


def dh_shared(peer_public: int, private: int, p: int = DEFAULT_PRIME) -> int:
    return pow(peer_public, private, p)


# --- float <-> field bridging for model aggregation -------------------------


def quantize(x: np.ndarray, scale: float = 2**16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Map floats to field elements (two's-complement style around p)."""
    q = np.round(np.asarray(x, np.float64) * scale).astype(np.int64)
    return q % p


def dequantize(q: np.ndarray, scale: float = 2**16, p: int = DEFAULT_PRIME) -> np.ndarray:
    q = np.asarray(q, np.int64) % p
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale


def secure_sum(client_vectors: list[np.ndarray], threshold: int | None = None,
               p: int = DEFAULT_PRIME, seed: int = 0) -> np.ndarray:
    """End-to-end secure aggregation demo: each client BGW-shares its
    quantized vector; servers sum shares pointwise; the sum polynomial is
    decoded from threshold+1 share-sums. Returns the float sum."""
    n = len(client_vectors)
    threshold = threshold if threshold is not None else max(1, (n - 1) // 2)
    share_sum = None
    for i, vec in enumerate(client_vectors):
        shares = bgw_encode(quantize(vec, p=p), n, threshold, p, seed=seed + i)
        share_sum = shares if share_sum is None else (share_sum + shares) % p
    idx = np.arange(threshold + 1)
    summed = bgw_decode(share_sum[idx], idx, p)
    return dequantize(summed, p=p)
