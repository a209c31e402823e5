"""Parity of the port's SMPL fitting with hig_tpu on the CPU.

- The synthetic model (at 64 vertices and at SMPL's 6890) and prior equal to
  JAX's bit for bit; the .npz and .pkl loaders against JAX's on the same
  files; the weight bridge from JAX's ``SMPLModel`` and ``GMMPrior``.
- ``lbs`` vertices and joints against JAX's vmapped ``lbs`` within 1e-5 of
  the largest magnitude; the joints-only path against the full path within
  1e-5; the prior and every loss term within 1e-5.
- The L-BFGS against ``optax.lbfgs`` iterate by iterate for 10 iterations
  (and the same line-search step counts) on an objective that takes zoom
  steps, within 1e-4 of each iterate's largest magnitude.
- ``SMPLify3D``'s final objective within 1% of JAX's at 64 vertices, 3
  frames, 5 iterations (the camera stage 10), with the collision term (its
  body stage skins the vertices; the camera stage reads the joints alone).
- ``python -m hig_tpu_torch.render_smpl --no-gif``, its refusals (--gif
  without matplotlib, --mean_params without h5py), and ``serve --fit_smpl``.

``torch.set_num_threads(1)``. float32 throughout: no line-search branch
flips between the two packages here.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hig_tpu.smpl import lbs as jl
from hig_tpu.smpl import prior as jp
from hig_tpu.smpl import smplify as js
from hig_tpu_torch.smpl import lbs as tl
from hig_tpu_torch.smpl import prior as tp
from hig_tpu_torch.smpl import smplify as ts
from hig_tpu_torch.smpl.lbfgs import lbfgs_run
from hig_tpu_torch.weights import gmm_prior_from, smpl_model_from

TOL = 1e-5
LBFGS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    return jl.synthetic_smpl_model(64), tl.synthetic_smpl_model(64)


def same_arrays(jax_model, port_model):
    for f in tl.FIELDS:
        a, b = np.asarray(getattr(jax_model, f)), getattr(port_model, f).numpy()
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), f
    assert tuple(jax_model.parents) == port_model.parents


@pytest.mark.parametrize("n_vertices", [64, 6890])
def test_synthetic_model_and_prior_equal_jax(n_vertices):
    same_arrays(jl.synthetic_smpl_model(n_vertices, seed=3),
                tl.synthetic_smpl_model(n_vertices, seed=3))
    jpr, tpr = jp.synthetic_gmm_prior(seed=2), tp.synthetic_gmm_prior(seed=2)
    for f in ("means", "precisions", "nll_weights"):
        assert np.array_equal(np.asarray(getattr(jpr, f)), getattr(tpr, f).numpy()), f


def test_loaders_and_bridge_match_jax(models, tmp_path):
    jm, tm = models
    npz = str(tmp_path / "smpl.npz")
    tl.save_smpl_npz(tm, npz)
    same_arrays(jl.load_smpl_model(npz), tl.load_smpl_model(npz))
    same_arrays(jm, tl.load_smpl_model(npz))
    # the .pkl layout: a sparse J_regressor, posedirs (V, 3, 207), faces
    import scipy.sparse

    V = tm.num_vertices
    d = dict(np.load(npz))
    d["J_regressor"] = scipy.sparse.csc_matrix(d["J_regressor"])
    d["f"] = np.arange(3 * 10).reshape(10, 3)
    pkl = str(tmp_path / "smpl.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(d, f)
    jpk, tpk = jl.load_smpl_model(pkl), tl.load_smpl_model(pkl)
    same_arrays(jpk, tpk)
    assert np.array_equal(np.asarray(jpk.faces), tpk.faces.numpy())
    assert tpk.posedirs.shape == (207, V * 3)
    same_arrays(jm, smpl_model_from(jm))
    jpr = jp.synthetic_gmm_prior()
    gmm = {"means": rand(8, 69, seed=1), "weights": np.full(8, 1 / 8),
           "covars": np.stack([np.eye(69) * (0.3 + 0.01 * k) for k in range(8)])}
    path = str(tmp_path / "gmm.pkl")
    with open(path, "wb") as f:
        pickle.dump(gmm, f)
    for got, want in ((tp.load_gmm_prior(path), jp.load_gmm_prior(path)),
                      (gmm_prior_from(jpr), jpr)):
        for f in ("means", "precisions", "nll_weights"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f


def test_gmm_loader_refuses_a_sklearn_object(tmp_path):
    path = tmp_path / "gmm_sklearn.pkl"
    # a pickled sklearn.mixture.GaussianMixture (protocol 0: GLOBAL, EMPTY_TUPLE, NEWOBJ)
    path.write_bytes(b"csklearn.mixture\nGaussianMixture\n)\x81.")
    # without sklearn the unpickling fails, with it the object is no dict:
    # either way the refusal names sklearn
    with pytest.raises(ValueError, match="sklearn"):
        tp.load_gmm_prior(str(path))
    other = tmp_path / "list.pkl"
    other.write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(ValueError, match="dict layout"):
        tp.load_gmm_prior(str(other))


def test_lbs_and_joints_only_match_jax(models):
    jm, tm = models
    betas, pose, transl = rand(2, 3, 10, seed=1, scale=0.5), rand(2, 3, 72, seed=2, scale=0.4), \
        rand(2, 3, 3, seed=3)
    jv, jj = jax.vmap(jax.vmap(lambda b, p, t: jl.lbs(jm, b, p, t)))(betas, pose, transl)
    tv, tj = tl.lbs(tm, *map(torch.from_numpy, (betas, pose, transl)))
    assert tv.shape == (2, 3, 64, 3) and tj.shape == (2, 3, 24, 3)
    close(tv, jv)
    close(tj, jj)
    close(tl.lbs_joints(tm, *map(torch.from_numpy, (betas, pose, transl))), tj)
    close(tl.lbs_joints(tm, *map(torch.from_numpy, (betas, pose))),
          tl.lbs(tm, *map(torch.from_numpy, (betas, pose)))[1])
    close(tl.rodrigues(torch.from_numpy(pose[0].reshape(-1, 3))),
          jl.rodrigues(jnp.asarray(pose[0].reshape(-1, 3))))


def test_prior_and_losses_match_jax(models):
    jm, tm = models
    jpr, tpr = jp.synthetic_gmm_prior(), tp.synthetic_gmm_prior()
    n = 3
    body = rand(n, 69, seed=4, scale=0.3)
    close(tpr(torch.from_numpy(body)), jpr(jnp.asarray(body)))
    x = rand(n, 22, 3, seed=5)
    close(ts.gmof(torch.from_numpy(x), 0.5), js.gmof(jnp.asarray(x), 0.5))
    close(ts.angle_prior(torch.from_numpy(body)), js.angle_prior(jnp.asarray(body)))
    verts = rand(n, 16, 3, seed=6, scale=0.05)
    parts = ts.vertex_parts(tm)[::4]
    assert np.array_equal(parts.numpy(), np.asarray(js.vertex_parts(jm))[::4])
    close(ts.collision_loss(torch.from_numpy(verts), parts, margin=0.05),
          js.collision_loss(jnp.asarray(verts), jnp.asarray(parts.numpy()), margin=0.05))
    mj, j3d = rand(n, 24, 3, seed=7), rand(n, 22, 3, seed=8)
    close(ts.guess_init_3d(torch.from_numpy(mj), torch.from_numpy(j3d)),
          js.guess_init_3d(jnp.asarray(mj), jnp.asarray(j3d)))
    cam, cam0 = rand(n, 3, seed=9), rand(n, 3, seed=10)
    close(ts.camera_fitting_loss_3d(*map(torch.from_numpy, (mj[:, :22], cam, cam0, j3d))),
          js.camera_fitting_loss_3d(*map(jnp.asarray, (mj[:, :22], cam, cam0, j3d))))
    betas, conf = rand(n, 10, seed=11), np.linspace(1, 1.5, 22).astype(np.float32)
    args = (body, body * 0.5, betas, mj[:, :22], cam, j3d)
    close(ts.body_fitting_loss_3d(*map(torch.from_numpy, args), tpr, torch.from_numpy(conf),
                                  pose_preserve_weight=5.0),
          js.body_fitting_loss_3d(*map(jnp.asarray, args), jpr, jnp.asarray(conf),
                                  pose_preserve_weight=5.0))


def rosenbrock(lib):
    def f(p):
        x = p["x"]
        rb = lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
        return rb + lib.sum(3.0 * p["s"] ** 2 + 0.5 * lib.exp(p["s"]))
    return f


def test_lbfgs_follows_optax_iterate_by_iterate():
    fj, ft = rosenbrock(jnp), rosenbrock(torch)
    p0 = {"x": rand(6, seed=1, scale=0.5), "s": rand(4, seed=2)}
    opt, vg = optax.lbfgs(), optax.value_and_grad_from_state(fj)

    @jax.jit
    def step(p, s):
        v, g = vg(p, state=s)
        u, s = opt.update(g, s, p, value=v, grad=g, value_fn=fj)
        return optax.apply_updates(p, u), s, v, optax.tree_utils.tree_get(
            s, "num_linesearch_steps")

    p, s = jax.tree_util.tree_map(jnp.asarray, p0), opt.init(p0)
    want, values, steps = [p], [], []
    for _ in range(10):
        p, s, v, n = step(p, s)
        want.append(p)
        values.append(float(v))
        steps.append(int(n))
    got, got_values, info = lbfgs_run(ft, {k: torch.from_numpy(v) for k, v in p0.items()}, 10,
                                      record_iterates=True)
    assert info.linesearch_steps == steps and max(steps) > 1  # zoom steps taken
    assert info.evaluations == 1 + sum(steps)
    for w, g in zip(want, info.iterates):
        for k in w:
            close(g[k], w[k], LBFGS_TOL)
    close(got_values, np.asarray(values), LBFGS_TOL)
    for k in got:
        assert torch.equal(got[k], info.iterates[-1][k])


def test_smplify_matches_jax(models):
    jm, tm = models
    jpr, tpr = jp.synthetic_gmm_prior(), tp.synthetic_gmm_prior()
    n = 3
    _, joints = jax.vmap(lambda b, p: jl.lbs(jm, b, p))(rand(n, 10, seed=1, scale=0.5),
                                                         rand(n, 72, seed=2, scale=0.3))
    j3d = (np.asarray(joints)[:, :22] + rand(n, 22, 3, seed=3, scale=0.02)
           + np.array([0.3, -0.1, 0.5], np.float32))
    conf = np.ones(22, np.float32)
    conf[[7, 8, 10, 11]] = 1.5
    kw = dict(num_iters=5, camera_outer=2, use_collision=True, collision_stride=4)
    want = js.SMPLify3D(model=jm, prior=jpr, **kw)(jnp.zeros((n, 72)), jnp.zeros((n, 10)),
                                                    jnp.asarray(j3d), jnp.asarray(conf))
    got = ts.SMPLify3D(model=tm, prior=tpr, **kw)(torch.zeros(n, 72), torch.zeros(n, 10),
                                                   torch.from_numpy(j3d), torch.from_numpy(conf))
    assert abs(float(got.final_loss) - float(want.final_loss)) <= 0.01 * float(want.final_loss)
    assert got.vertices.shape == (n, 64, 3) and got.joints.shape == (n, 24, 3)
    assert got.camera_info.evaluations >= 10 and len(got.body_info.linesearch_steps) == 5
    close(got.camera_translation, want.camera_translation, 1e-2)


# --- the CLIs ---------------------------------------------------------------------


@pytest.fixture
def joints_file(models, tmp_path):
    _, tm = models
    _, joints = tl.lbs(tm, torch.zeros(2, 5, 10),
                       torch.from_numpy(rand(2, 5, 72, seed=4, scale=0.2)))
    path = str(tmp_path / "pair.npy")
    np.save(path, joints[..., :22, :].numpy() + 0.1)
    return path


def test_render_smpl_cli(joints_file, tmp_path, monkeypatch, capsys):
    from hig_tpu_torch import render_smpl

    out = str(tmp_path / "smpl")
    result = render_smpl.main(["--file_name", joints_file, "--save_dir", out, "--no-gif",
                               "--num_smplify_iters", "2", "--device", "cpu"])
    with open(os.path.join(out, "pair.pkl"), "rb") as f:
        mesh1, mesh2 = pickle.load(f)
    assert mesh1.shape == mesh2.shape == (5, 512, 3) and np.isfinite(mesh1).all()
    params = np.load(os.path.join(out, "pair_params.npz"))
    assert params["pose"].shape == (10, 72) and params["joints"].shape == (10, 24, 3)
    assert np.isfinite(float(result.final_loss))
    assert "evaluations" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out, "pair.gif"))

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "pyrender", None)
    with pytest.raises(RuntimeError, match="--no-gif"):
        render_smpl.main(["--file_name", joints_file, "--save_dir", out, "--device", "cpu"])
    h5 = tmp_path / "mean.h5"
    h5.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        render_smpl.main(["--file_name", joints_file, "--save_dir", out, "--no-gif",
                          "--mean_params", str(h5), "--device", "cpu"])


def test_serve_fit_smpl(tmp_path, models, capsys):
    from hig_tpu_torch import serve
    from hig_tpu_torch.data.vocab import CLASSID2CAPS

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(num_layers=1, latent_dim=32, ff_size=64, num_heads=4,
                                   text_latent_dim=16, text_ff_size=32, num_text_layers=1,
                                   cap_id=True)))
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps({"caption1": CLASSID2CAPS[k][0],
                                        "caption2": CLASSID2CAPS[k][1], "length": 4,
                                        "id": f"r{k}"}) + "\n" for k in range(2)))
    npz = str(tmp_path / "smpl64.npz")
    tl.save_smpl_npz(models[1], npz)
    out = tmp_path / "out"
    serve.main(["--requests", str(reqs), "--random_init", "0", "--model_config", str(cfg),
                "--ddim_steps", "2", "--diffusion_steps", "100", "--device", "cpu",
                "--out_dir", str(out), "--fit_smpl", "--smpl_model", npz])
    index = json.loads((out / "index.json").read_text())
    for entry in index:
        fit = np.load(entry["smpl"])
        assert entry["smpl"] == str(out / f"{entry['id']}_smpl.npz")
        assert fit["pose"].shape == (8, 72) and fit["betas"].shape == (8, 10)
        assert fit["cam_t"].shape == (8, 3) and np.isfinite(fit["pose"]).all()
    assert capsys.readouterr().out.count("fit SMPL to") == 2
