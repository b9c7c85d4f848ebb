"""Float64 NumPy oracles for parity testing.

Independent, vectorised re-implementations of the *mathematics* the reference
scripts compute (R&W Algorithms 2.1 / 3.1 / 3.3 and the GPML sec. 5.4.3
composite kernel), used as the ground truth the JAX implementations must
match (SURVEY.md sec. 4, test-strategy item 1/3). Citations point at the
reference lines each formula mirrors; known reference bugs (SURVEY.md quirks
Q1-Q5) are *not* reproduced — the corrected math is the spec.
"""

import numpy as np
from scipy.linalg import cho_factor, cho_solve, solve_triangular


# --- kernels ---------------------------------------------------------------

def rbf(a, b, sigma, ell):
    """[ref: GP_regression.py:8-19]"""
    a = np.atleast_2d(a.astype(np.float64))
    b = np.atleast_2d(b.astype(np.float64))
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return sigma**2 * np.exp(-0.5 * d2 / ell**2)


def linear(a, b, c):
    """[ref: GP_regression.py:22-33]"""
    return (a - c) @ (b - c).T


def periodic(a, b, period, ell):
    """[ref: GP_regression.py:36-50]"""
    d = np.abs(a - b.T)
    return np.exp(-2.0 * np.sin(np.pi * d / period) ** 2 / ell**2)


def co2_composite(a, b, theta, same):
    """GPML sec. 5.4.3 composite. [ref: CO2_example.py:9-94]"""
    a = np.atleast_2d(a.astype(np.float64))
    b = np.atleast_2d(b.astype(np.float64))
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    d = np.sqrt(d2)
    t = np.asarray(theta, dtype=np.float64)
    k1 = t[0] ** 2 * np.exp(-0.5 * d2 / t[1] ** 2)
    k2 = t[2] ** 2 * np.exp(-0.5 * d2 / t[3] ** 2 - 2.0 * (np.sin(np.pi * d) / t[4]) ** 2)
    k3 = t[5] ** 2 * (1.0 + 0.5 * d2 / (t[7] * t[6] ** 2)) ** (-t[7])
    k4 = t[8] ** 2 * np.exp(-0.5 * d2 / t[9] ** 2)
    if same:
        k4 = k4 + t[10] ** 2 * np.eye(a.shape[0])
    return k1 + k2 + k3 + k4


# --- exact regression (R&W Alg 2.1) ---------------------------------------

def exact_posterior(K, K_s, kss_diag, y, noise):
    """[ref: GP_regression.py:138-151] with the corrected LML
    [ref: tune_hyperparms_regression.py:141]."""
    n = K.shape[0]
    L = np.linalg.cholesky(K + noise * np.eye(n))
    alpha = solve_triangular(L.T, solve_triangular(L, y, lower=True), lower=False)
    mean = K_s.T @ alpha
    v = solve_triangular(L, K_s, lower=True)
    var = kss_diag - (v**2).sum(0)
    lml = (
        -0.5 * y @ alpha
        - np.log(np.diag(L)).sum()
        - 0.5 * n * np.log(2 * np.pi)
    )
    return mean, var, lml, L, alpha, v


def lml_only(K, y, noise):
    n = K.shape[0]
    L = np.linalg.cholesky(K + noise * np.eye(n))
    alpha = solve_triangular(L.T, solve_triangular(L, y, lower=True), lower=False)
    return (
        -0.5 * y @ alpha
        - np.log(np.diag(L)).sum()
        - 0.5 * n * np.log(2 * np.pi)
    )


# --- binary Laplace (true Newton; R&W Alg 3.1) ----------------------------

def laplace_binary_mode(K, y, max_iters=100, tol=1e-10):
    """True Newton to the mode of the logistic-link Laplace approximation —
    W and the gradient recomputed at the current iterate (the reference
    freezes them at the prior sample, quirk Q2
    [ref: GP_binary_classification.py:104-105]).
    """
    n = K.shape[0]
    f = np.zeros(n)
    for _ in range(max_iters):
        pi = 1.0 / (1.0 + np.exp(-f))
        t = (y + 1) / 2.0
        grad = t - pi
        W = pi * (1 - pi)
        sW = np.sqrt(W)
        B = np.eye(n) + sW[:, None] * K * sW[None, :]
        L = np.linalg.cholesky(B)
        b = W * f + grad
        inner = solve_triangular(
            L.T, solve_triangular(L, sW * (K @ b), lower=True), lower=False
        )
        a = b - sW * inner
        f_new = K @ a
        if np.linalg.norm(f_new - f) < tol:
            f = f_new
            break
        f = f_new
    pi = 1.0 / (1.0 + np.exp(-f))
    return f, a, L, np.sqrt(pi * (1 - pi)), (y + 1) / 2.0 - pi


def laplace_binary_predict(K_s, kss_diag, f_mode_grad, L, sW):
    """R&W Alg 3.2 mean/variance [ref: GP_binary_classification.py:136-154]."""
    mean = K_s.T @ f_mode_grad
    v = solve_triangular(L, sW[:, None] * K_s, lower=True)
    var = kss_diag - (v**2).sum(0)
    return mean, var


def laplace_binary_reference_mode(K, y, f_prior, max_iters=10000, tol=1e-4):
    """Transliteration of the reference's frozen-W training loop (quirk Q2)
    [ref: GP_binary_classification.py:86-133]: grad/W evaluated once at the
    prior sample, f iterated from zero through the linearised update.
    Returns (f_fixed_point, grad0, L, sW) — grad0/L/sW are what the
    reference's prediction consumes [ref: :136-154]."""
    from scipy.special import expit

    n = len(y)
    t = (y + 1.0) / 2.0
    grad0 = t - expit(y * f_prior)              # deriv at y*f_prior [ref: :74]
    pi0 = expit(f_prior)
    W = pi0 * (1.0 - pi0)                       # -sec_deriv at f_prior [ref: :83]
    sW = np.sqrt(W)
    L = np.linalg.cholesky(np.eye(n) + sW[:, None] * K * sW[None, :])
    f = np.zeros(n)
    for _ in range(max_iters):
        b = W * f + grad0
        inner = np.linalg.solve(L.T, np.linalg.solve(L, sW * (K @ b)))
        a = b - sW * inner
        f_new = K @ a
        err = np.sqrt(np.sum((f_new - f) ** 2))
        f = f_new
        if err <= tol:
            break
    return f, grad0, L, sW


def multiclass_reference_mode(K_full, y_stacked, C, n, max_iters=10000, tol=0.01):
    """Transliteration of the reference's damped trainer2 with its quirks
    (Q4 sign, half-solve) [ref: GP_multi_classification.py:129-176]; stride
    generalised to n (Q3). Returns (f, pi_vector)."""
    s = 3.0
    step_size = 1e-4
    N = C * n
    L = np.linalg.cholesky(s * np.eye(N) + K_full)
    L_inv = np.linalg.inv(L)
    A_inv = L_inv.T @ L_inv
    f = np.zeros(N)
    piv = np.zeros(N)
    for _ in range(max_iters):
        fm = f.reshape(C, n)
        e = np.exp(fm - fm.max(axis=0, keepdims=True))
        pi_cn = e / e.sum(axis=0, keepdims=True)
        piv = pi_cn.reshape(N)
        Pi = np.zeros((N, n))
        for c in range(C):
            Pi[c * n: (c + 1) * n] = np.diag(pi_cn[c])
        W = np.diag(piv) - Pi @ Pi.T
        sec_deri = A_inv + W
        L_sd = np.linalg.cholesky(s * np.eye(N) + sec_deri)
        L_inv_sd = np.linalg.inv(L_sd)
        rhs = ((1 - step_size) * A_inv + W) @ f + y_stacked + piv
        f_new = L_inv_sd @ rhs
        err = np.sqrt(np.sum((f_new - f) ** 2))
        f = f_new
        if err <= tol:
            break
    return f, piv
