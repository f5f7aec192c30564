"""Every ported core function of moda_tpu_torch against its moda_tpu
counterpart: the same numpy inputs through both, values and gradients
(vector-Jacobian products with a fixed random cotangent), fp32.

Tolerance: atol 1e-5 / rtol 1e-5 on values and gradients unless a case
states otherwise (each case's reason next to it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moda_tpu.core import camera as JC, density as JD, dualquat as JDQ, embedding as JE
from moda_tpu.core import quat as JQ, sampling as JS, se3 as JSE3, skinning as JSK
from moda_tpu.ops import sinkhorn as JOT
from moda_tpu_torch.core import camera as TC, density as TD, dualquat as TDQ, embedding as TE
from moda_tpu_torch.core import quat as TQ, sampling as TS, se3 as TSE3, skinning as TSK
from moda_tpu_torch.ops import sinkhorn as TOT

R = np.random.default_rng(7)


def _quat(*shape):
    q = R.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rot(*shape):
    return np.asarray(JQ.q_to_matrix(jnp.asarray(_quat(*shape))))


def _n(*shape, s=1.0):
    return (R.normal(size=shape) * s).astype(np.float32)


def _dq(*shape):
    return np.asarray(JDQ.rt_to_dq(jnp.asarray(_quat(*shape)), jnp.asarray(_n(*shape, 3, s=0.2))))


def _bones(B):
    return np.concatenate([_n(B, 3, s=0.1), _quat(B), _n(B, 3, s=0.2)], -1)


def _rtk(*shape):
    return np.concatenate([_rot(*shape).reshape(shape + (9,)), _n(*shape, 3, s=0.3)], -1)


def _kvec(B):
    return np.stack([R.uniform(50, 80, B), R.uniform(50, 80, B), R.uniform(20, 40, B),
                     R.uniform(20, 40, B)], -1).astype(np.float32)


def _tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


# name -> (jax fn, torch fn, inputs, indices of differentiable inputs, atol)
CASES = {
    "safe_norm": (JQ.safe_norm, TQ.safe_norm, [_n(5, 3)], [0], 1e-5),
    "q_normalize": (JQ.q_normalize, TQ.q_normalize, [_n(6, 4)], [0], 1e-5),
    "q_mul": (JQ.q_mul, TQ.q_mul, [_n(6, 4), _n(6, 4)], [0, 1], 1e-5),
    "q_invert": (JQ.q_invert, TQ.q_invert, [_n(6, 4)], [0], 1e-5),
    "q_apply": (JQ.q_apply, TQ.q_apply, [_quat(6), _n(6, 3)], [0, 1], 1e-5),
    "q_to_matrix": (JQ.q_to_matrix, TQ.q_to_matrix, [_n(6, 4)], [0], 1e-5),
    "matrix_to_q": (JQ.matrix_to_q, TQ.matrix_to_q, [_rot(8)], [0], 1e-4),
    "axis_angle_to_q": (JQ.axis_angle_to_q, TQ.axis_angle_to_q,
                        [np.concatenate([_n(5, 3), np.zeros((1, 3), np.float32)])], [0], 1e-5),
    "so3_exp": (JQ.so3_exp, TQ.so3_exp, [_n(6, 3)], [0], 1e-5),
    # arccos' slope near +-1 amplifies fp32 rounding of the trace
    "rot_angle": (JQ.rot_angle, TQ.rot_angle, [_rot(6)], [0], 1e-4),
    "dq_mul": (JDQ.dq_mul, TDQ.dq_mul, [_n(5, 8), _n(5, 8)], [0, 1], 1e-5),
    "dq_normalize": (JDQ.dq_normalize, TDQ.dq_normalize, [_n(5, 8)], [0], 1e-5),
    "dq_inverse": (JDQ.dq_inverse, TDQ.dq_inverse, [_n(5, 8)], [0], 1e-5),
    "rt_to_dq": (JDQ.rt_to_dq, TDQ.rt_to_dq, [_quat(5), _n(5, 3)], [0, 1], 1e-5),
    "dq_to_rt": (JDQ.dq_to_rt, TDQ.dq_to_rt, [_dq(5)], [0], 1e-5),
    "dq_apply": (JDQ.dq_apply, TDQ.dq_apply, [_dq(5), _n(5, 3)], [0, 1], 1e-5),
    "rts_invert": (JSE3.rts_invert, TSE3.rts_invert,
                   [np.concatenate([_rot(4), _n(4, 3, 1)], -1)], [0], 1e-5),
    "rtk_invert": (JSE3.rtk_invert, TSE3.rtk_invert, [_rtk(4)], [0], 1e-5),
    "rtk_compose": (JSE3.rtk_compose, TSE3.rtk_compose, [_rtk(4), _rtk(4)], [0, 1], 1e-5),
    "vec_to_sim3": (JSE3.vec_to_sim3, TSE3.vec_to_sim3, [_bones(5)], [0], 1e-5),
    "se3_refine": (JSE3.se3_refine, TSE3.se3_refine,
                   [np.concatenate([_rot(4), _n(4, 3, 1)], -1), _rot(4), _n(4, 3)], [0, 1, 2],
                   1e-5),
    "K2mat": (JC.K2mat, TC.K2mat, [_kvec(4)], [0], 1e-5),
    "K2inv": (JC.K2inv, TC.K2inv, [_kvec(4)], [0], 1e-5),
    "Kmatinv": (JC.Kmatinv, TC.Kmatinv, [np.asarray(JC.K2mat(jnp.asarray(_kvec(4))))], [0], 1e-5),
    "obj_to_cam": (JC.obj_to_cam, TC.obj_to_cam, [_n(4, 7, 3), _rot(4), _n(4, 3)], [0, 1, 2],
                   1e-5),
    "pinhole_cam": (JC.pinhole_cam, TC.pinhole_cam,
                    [_n(4, 7, 3) * 0.1 + np.asarray([0, 0, 2], np.float32), _kvec(4)], [0, 1],
                    1e-4),
    "raycast": (lambda *a: tuple(JC.raycast(*a)), lambda *a: tuple(TC.raycast(*a)),
                [R.uniform(0, 16, (3, 5, 2)).astype(np.float32), _rot(3), _n(3, 3),
                 np.asarray(JC.K2inv(jnp.asarray(_kvec(3)))),
                 np.asarray([[0.1, 2.0]] * 3, np.float32)], [1, 2, 3], 1e-5),
    "prepare_ray_cams": (JC.prepare_ray_cams, TC.prepare_ray_cams,
                         [np.concatenate([np.concatenate([_rot(3), _n(3, 3, 1)], -1),
                                          _kvec(3)[:, None]], 1),
                          np.asarray([[1.0, 1.0, 0.0, 0.0]] * 3, np.float32)], [0], 1e-4),
    "positional_embed": (lambda x: JE.positional_embed(x, 10), lambda x: TE.positional_embed(x, 10),
                         [_n(6, 3, s=0.3)], [0], 1e-4),
    "positional_embed_window": (lambda x: JE.positional_embed(x, 10, alpha=6.3),
                                lambda x: TE.positional_embed(x, 10, alpha=6.3),
                                [_n(6, 3, s=0.3)], [0], 1e-4),
    "positional_embed_dir": (lambda x: JE.positional_embed(x, 4, alpha=2.5),
                             lambda x: TE.positional_embed(x, 4, alpha=2.5),
                             [_n(6, 3)], [0], 1e-5),
    "window_vec": (lambda a: JE.window_vec(10, 3, a), lambda a: TE.window_vec(10, 3, a),
                   [np.asarray(4.6, np.float32)], [0], 1e-5),
    "sdf_to_sigma": (lambda s, b: JD.sdf_to_sigma(s, b, beta_min=0.02),
                     lambda s, b: TD.sdf_to_sigma(s, b, beta_min=0.02),
                     [_n(4, 9, s=0.1), np.asarray(0.05, np.float32)], [0, 1], 1e-4),
    "ray_deltas": (JD.ray_deltas, TD.ray_deltas,
                   [np.sort(R.uniform(1, 2, (4, 9)), -1).astype(np.float32), _n(4, 3)], [0, 1],
                   1e-5),
    "compositing_weights": (JD.compositing_weights, TD.compositing_weights,
                            [R.uniform(0, 5, (4, 9)).astype(np.float32),
                             R.uniform(0.01, 0.1, (4, 9)).astype(np.float32)], [0, 1], 1e-5),
    "sample_pdf_det": (lambda b, w: JS.sample_pdf(b, w, 6, None, det=True),
                       lambda b, w: TS.sample_pdf(b, w, 6, det=True),
                       [np.sort(R.uniform(1, 2, (4, 8)), -1).astype(np.float32),
                        R.uniform(0, 1, (4, 7)).astype(np.float32)], [0, 1], 1e-4),
    "generate_bones": (lambda: JSK.generate_bones(3, 25, 0.0),
                       lambda: TSK.generate_bones(3, 25, 0.0), [], [], 0.0),
    "skinning_weights": (lambda b, p, ls: JSK.skinning_weights(b, p, None, ls),
                         lambda b, p, ls: TSK.skinning_weights(b, p, None, ls),
                         [_bones(5)[None].repeat(3, 0), _n(3, 7, 3, s=0.1),
                          np.asarray(-2.0, np.float32)], [0, 1, 2], 1e-4),
    "bone_transform_dq": (JSK.bone_transform_dq, TSK.bone_transform_dq,
                          [_bones(5), _dq(3, 5)], [0, 1], 1e-5),
    "bone_transform_rts": (JSK.bone_transform_rts, TSK.bone_transform_rts,
                           [_bones(5), _rtk(3, 5)], [0, 1], 1e-4),
    "neu_dbs_backward": (lambda b, d, s, p: JSK.neu_dbs(b, d, s, p, backward=True),
                         lambda b, d, s, p: TSK.neu_dbs(b, d, s, p, backward=True),
                         [_bones(5), _dq(3, 5), np.asarray(jax.nn.softmax(_n(3, 7, 5), -1)),
                          _n(3, 7, 3, s=0.1)], [0, 1, 2, 3], 1e-5),
    "neu_dbs_forward": (lambda b, d, s, p: JSK.neu_dbs(b, d, s, p, backward=False),
                        lambda b, d, s, p: TSK.neu_dbs(b, d, s, p, backward=False),
                        [_bones(5), _dq(3, 5), np.asarray(jax.nn.softmax(_n(3, 7, 5), -1)),
                         _n(3, 7, 3, s=0.1)], [0, 1, 2, 3], 1e-5),
    "lbs_backward": (lambda b, r, s, p: JSK.lbs(b, r, s, p, backward=True),
                     lambda b, r, s, p: TSK.lbs(b, r, s, p, backward=True),
                     [_bones(5), _rtk(3, 5), np.asarray(jax.nn.softmax(_n(3, 7, 5), -1)),
                      _n(3, 7, 3, s=0.1)], [1, 2, 3], 1e-4),
    "correct_bones_dq": (JSK.correct_bones_dq, TSK.correct_bones_dq,
                         [_bones(5), _dq(1, 5)], [0, 1], 1e-5),
    "correct_rest_pose_dq": (JSK.correct_rest_pose_dq, TSK.correct_rest_pose_dq,
                             [_dq(3, 5), _dq(5)], [0, 1], 1e-5),
    # 50 log-domain iterations at eps 2.5e-3: fp32 reassociation grows
    "sinkhorn_divergence": (JOT.sinkhorn_divergence, TOT.sinkhorn_divergence,
                            [_n(5, 3, s=1.0), _n(20, 3, s=1.0)], [0, 1], 1e-4),
}


def _vjp_jax(fn, args, diff, cots):
    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return _tuple(fn(*full))

    outs, pull = jax.vjp(f, *[args[i] for i in diff])
    return outs, pull(tuple(jnp.asarray(c) for c in cots))


@pytest.mark.parametrize("name", sorted(CASES))
def test_core_function_matches_jax(name):
    jfn, tfn, inputs, diff, atol = CASES[name]
    j_args = [jnp.asarray(x) for x in inputs]
    t_args = [torch.tensor(x, requires_grad=(i in diff)) for i, x in enumerate(inputs)]
    j_out = _tuple(jfn(*j_args))
    t_out = _tuple(tfn(*t_args))
    assert len(j_out) == len(t_out)
    for jo, to in zip(j_out, t_out):
        assert tuple(to.shape) == tuple(jo.shape), name
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=atol,
                                   rtol=max(atol, 1e-5), err_msg=name)
    if not diff:
        return
    cots = [np.random.default_rng(1).normal(size=o.shape).astype(np.float32) for o in j_out]
    _, j_grads = _vjp_jax(jfn, j_args, diff, cots)
    live = [(o, torch.tensor(c)) for o, c in zip(t_out, cots) if o.requires_grad]
    t_grads = torch.autograd.grad([o for o, _ in live], [t_args[i] for i in diff],
                                  [c for _, c in live], allow_unused=True)
    for i, jg, tg in zip(diff, j_grads, t_grads):
        tg = torch.zeros(inputs[i].shape) if tg is None else tg
        scale = max(1.0, float(np.abs(np.asarray(jg)).max()))
        np.testing.assert_allclose(tg.numpy() / scale, np.asarray(jg) / scale, atol=atol,
                                   rtol=max(atol, 1e-5), err_msg=f"{name} grad {i}")


def test_safe_norm_gradient_at_zero():
    """d|x|/dx at exactly 0 is NaN for a plain norm; safe_norm gives 0."""
    x = torch.zeros(4, 3, requires_grad=True)
    g, = torch.autograd.grad(TQ.safe_norm(x).sum(), x)
    jg = jax.grad(lambda v: JQ.safe_norm(v).sum())(jnp.zeros((4, 3)))
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_scatter_matrix_and_stratified_zvals():
    np.testing.assert_array_equal(TE.scatter_matrix(3, 10), JE.scatter_matrix(3, 10))
    near = np.full((4, 1), 1.0, np.float32)
    far = np.full((4, 1), 2.5, np.float32)
    key = jax.random.key(5)
    jz = JS.stratified_zvals(jnp.asarray(near), jnp.asarray(far), 9, key, perturb=1.0)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (4, 9))))
    tz = TS.stratified_zvals(torch.tensor(near), torch.tensor(far), 9, u=u, perturb=1.0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
