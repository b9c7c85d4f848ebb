import jax, jax.numpy as jnp, numpy as np
from gaussian_process_tpu import gp, ops
from gaussian_process_tpu.models import GPRegressor, GPBinaryClassifier, GPMulticlassClassifier
from gaussian_process_tpu.utils import datasets

x = jnp.asarray(np.random.default_rng(0).uniform(-5,5,(5,1)), jnp.float32)
y = jnp.sin(0.9*x).ravel()
xs = jnp.linspace(-5,5,100,dtype=jnp.float32).reshape(-1,1)
k = ops.RBF(); p = k.init_params()
post = gp.posterior(k, p, x, y, xs)
print("posterior:", float(post.lml), bool(jnp.isfinite(post.mean).all()))

g = jax.grad(lambda pp: gp.log_marginal_likelihood(k, pp, x, y))(p)
print("grad:", {kk: float(v) for kk, v in g.items()}, all(np.isfinite(float(v)) for v in g.values()))

xd = jnp.concatenate([x, x]); yd = jnp.concatenate([y, y])
res = gp.posterior(k, p, xd, yd, xs, noise_variance=0.0)
print("dup-points jitter:", float(res.jitter), bool(jnp.isfinite(res.mean).all()))

km = ops.Matern(nu=1.5); pm = km.init_params()
pmat = gp.posterior(km, pm, x, y, xs)
gm = jax.grad(lambda pp: gp.log_marginal_likelihood(km, pp, x, y))(pm)
print("matern:", bool(jnp.isfinite(pmat.mean).all()), float(gm["lengthscale"]))

xtr, xte, ytr, yte = datasets.binary_dataset("moons")
acc_b = GPBinaryClassifier(ops.RBF()).fit(np.float32(xtr), ytr).score(np.float32(xte), yte)
xtr2, xte2, ytr2, yte2 = datasets.blobs_multiclass()
acc_m = GPMulticlassClassifier(ops.RBF(), 3).fit(np.float32(xtr2), ytr2).score(np.float32(xte2), yte2)
f, xr, yr, xq = datasets.sine_regression(30, 50, seed=1)
reg = GPRegressor(ops.RBF()).fit(np.float32(xr), np.float32(yr), optimize=True, max_iters=100)
print("binary acc:", acc_b, "multi acc:", acc_m, "tuned lml:", float(reg.lml_))

xl = jnp.asarray(np.random.default_rng(1).uniform(-5,5,(300,3)), jnp.float32)
yl = jnp.sin(0.9*xl.sum(axis=1))
cgp = gp.posterior_cg(ops.RBF(), ops.RBF().init_params(), xl, yl, xl[:40], noise_variance=1e-2, tol=1e-6)
exact = gp.posterior(ops.RBF(), ops.RBF().init_params(), xl, yl, xl[:40], noise_variance=1e-2)
cg_mean_err = float(jnp.max(jnp.abs(cgp.mean - exact.mean)))
cg_var_err = float(jnp.max(jnp.abs(cgp.var - exact.var)))
print("posterior_cg vs chol:", cg_mean_err, cg_var_err, int(cgp.iters))
assert cg_mean_err < 1e-2 and cg_var_err < 1e-2

from gaussian_process_tpu import opt as _opt
est = float(_opt.lml_estimate(ops.RBF(), ops.RBF().init_params(), xl, yl, jax.random.key(0),
                              noise_variance=1e-2, num_probes=4, lanczos_iters=16, precond_rank=64))
exact_lml = float(gp.log_marginal_likelihood(ops.RBF(), ops.RBF().init_params(), xl, yl, noise_variance=1e-2))
print("matrix-free lml estimate:", round(est, 2), "exact:", round(exact_lml, 2))
assert abs(est - exact_lml) < 0.05 * xl.shape[0]
g_ls = jax.grad(lambda pp: _opt.lml_surrogate(ops.RBF(), pp, xl, yl, jax.random.key(1),
                noise_variance=1e-2, num_probes=4, cg_max_iters=300, precond_rank=64))(
    {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)})
print("large-scale grad (matvec vjp):", {k: round(float(v), 3) for k, v in g_ls.items()})
assert all(np.isfinite(float(v)) for v in g_ls.values())

theta = jnp.asarray([66,67,2.4,90,1.3,.66,1.2,.78,.18,1.6,.19], jnp.float32)
xc, yc, _co2_mean = datasets.mauna_loa()
kc = ops.co2_kernel(); pc = ops.co2_params_from_vector(theta)
lml = gp.log_marginal_likelihood(kc, pc, jnp.asarray(xc, jnp.float32), jnp.asarray(yc, jnp.float32), noise_variance=5e-4)
print("co2 lml:", float(lml), np.isfinite(float(lml)))
print("VERIFY-DRIVE-OK")
