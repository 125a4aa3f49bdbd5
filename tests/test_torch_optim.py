"""The port's RAdam, LARS and half-cycle schedule against the JAX
package's optax ones.

A small module whose parameters carry the flax names of every kind of
parameter group (each LR group with its no-decay twin, a 3-D relation
tensor, 1-D gates, learned tokens, the frozen chemCPA drug table and the
decoder) is given the same gradients in both packages for 8 steps, with
weight decay, a warmup-cosine schedule and a different LR a group. The
port runs in float64; each step's update (its change of the parameters)
must equal the JAX update of that step within 1e-6 of the tensor's
largest update. 8 steps, not 5: with beta2 = 0.9 RAdam's rho first
reaches the threshold 5 at step 6, so both of its branches run.

RAdam goes through the JAX package's `create_optimizer` with 64-bit
scalars (`jax.enable_x64`): in float32, optax's rho = rho_inf -
2 t b2^t / (1 - b2^t) cancels, which moves the rectification r by about
2e-6 at step 6, and the port computes it in float64. LARS is held to
the JAX package's `lars` transformation group by group, with each
group's learning rate, weight decay and schedule as `create_optimizer`
gives them: under `optax.multi_transform` (optax 0.2.6) the JAX `lars`
fails on the masked leaves of the other groups (an IndexError in its
`tree_map`), so the JAX package's `optim.optimizer=lars` does not run.
"""
import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from madrigal_tpu import config as j_config
from madrigal_tpu.train import optim as j_optim
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.train import optim as t_optim
from test_torch_train import one_thread  # noqa: F401  (fixture)

STEPS, WARMUP = 8, 2


class _Node(nn.Module):
    pass


def tiny_model() -> nn.Module:
    """Parameters at flax-named paths, one of each kind."""
    g = torch.Generator().manual_seed(0)
    root = _Node()
    enc = root.encoder = _Node()
    enc.str_encoder = _Node()
    enc.str_encoder.dense_0 = nn.Linear(4, 3)
    enc.str_encoder.eps = nn.Parameter(torch.zeros(1))
    enc.kg_encoder = _Node()
    enc.kg_encoder.k_rel__a__r__b = nn.Parameter(torch.randn(2, 3, 3,
                                                             generator=g))
    enc.kg_encoder.p_rel__a__r__b = nn.Parameter(torch.ones(2))
    enc.cv_encoder = _Node()
    enc.cv_encoder.dense_0 = nn.Linear(5, 3)
    enc.cv_encoder.norm_0 = nn.LayerNorm(3)
    enc.tx_encoder = _Node()
    enc.tx_encoder.drug_embeddings = nn.Embedding(6, 3)
    enc.transformer = _Node()
    enc.transformer.norm1 = nn.LayerNorm(3)
    enc.transformer.q_proj = nn.Linear(3, 3)
    enc.cls = nn.Parameter(torch.randn(1, 3, generator=g))
    root.decoder = _Node()
    root.decoder.weight = nn.Parameter(torch.randn(2, 3, 3, generator=g))
    with torch.no_grad():
        for p in root.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    return root.double()


def flax_tree(model: nn.Module, values=None) -> dict:
    """The flax params tree of `model` (or of `values`, a {name: array}
    of its parameters' shapes), Dense kernels as [in, out]."""
    tree = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            leaf = t_optim._flax_leaf(mod, pname)
            v = (p.detach().numpy() if values is None else values[key])
            v = np.asarray(v, np.float32)
            if leaf == "kernel":
                v = v.T
            node = tree
            for part in mname.split(".") if mname else ():
                node = node.setdefault(part, {})
            node[leaf] = v
    return tree


def flat(tree, model):
    """{torch parameter name: array in torch layout} of a flax tree."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            node = tree
            for part in mname.split(".") if mname else ():
                node = node[part]
            leaf = t_optim._flax_leaf(mod, pname)
            v = np.asarray(node[leaf], np.float64)
            out[f"{mname}.{pname}" if mname else pname] = (
                v.T if leaf == "kernel" else v)
    return out


def opt_cfg(c, name):
    return c.OptimizerConfig(
        optimizer=name, structure_encoder_lr=3e-2, kg_encoder_lr=2e-2,
        perturb_encoders_lr=1.5e-2, fusion_lr=1e-2, decoder_lr=5e-3,
        beta1=0.8, beta2=0.9, eps=1e-6, wd=0.05, momentum=0.85)


def radam_steps(model, params, frozen):
    """step(grads) -> {name: update} of the JAX package's RAdam optimizer
    (create_optimizer), its scalars in 64 bits."""
    cfg = opt_cfg(j_config, "radam")
    with jax.enable_x64(True):
        tx = j_optim.create_optimizer(params, cfg, warmup_epochs=WARMUP,
                                      total_epochs=STEPS,
                                      frozen_encoder=frozen)
        state = [tx.init(params), params]

    def step(grads):
        with jax.enable_x64(True):
            updates, state[0] = tx.update(flax_tree(model, grads), state[0],
                                          state[1])
            state[1] = optax.apply_updates(state[1], updates)
        return flat(updates, model)

    return step


def lars_steps(model, params, frozen):
    """step(grads) -> {name: update} of the JAX package's `lars`, one
    transformation a parameter group (create_optimizer's learning rate,
    schedule and weight decay for the group; frozen groups do not move)."""
    cfg = opt_cfg(j_config, "lars")
    lrs = {"str": cfg.structure_encoder_lr, "kg": cfg.kg_encoder_lr,
           "perturb": cfg.perturb_encoders_lr, "fusion": cfg.fusion_lr,
           "decoder": cfg.decoder_lr}
    label_of = {}
    for path, lab in jax.tree_util.tree_leaves_with_path(
            j_optim.param_labels(params)):
        label_of[tuple(k.key for k in path)] = lab
    names = flat_paths(model)
    values = flat(params, model)
    groups = {}
    for key, path in names.items():
        lab = label_of[path]
        if lab == "frozen" or (frozen and lab != "decoder"):
            continue
        groups.setdefault(lab, []).append(key)
    txs, states = {}, {}
    for lab, keys in groups.items():
        g = lab.removesuffix("_nd")
        txs[lab] = j_optim.lars(
            j_optim.warmup_cosine_schedule(lrs[g], WARMUP, STEPS),
            weight_decay=0.0 if lab.endswith("_nd") else cfg.wd,
            momentum=cfg.momentum)
        sub = {k: jax_layout(values[k], names[k]) for k in keys}
        states[lab] = [txs[lab].init(sub), sub]

    def step(grads):
        out = {k: np.zeros_like(v) for k, v in values.items()}
        for lab, (state, sub) in states.items():
            g = {k: jax_layout(grads[k].astype(np.float32), names[k])
                 for k in sub}
            upd, state = txs[lab].update(g, state, sub)
            sub = optax.apply_updates(sub, upd)
            states[lab] = [state, sub]
            for k, u in upd.items():
                u = np.asarray(u, np.float64)
                out[k] = u.T if names[k][-1] == "kernel" else u
        return out

    return step


def flat_paths(model):
    """{torch parameter name: its flax path}."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = tuple(
                mname.split(".") if mname else ()) + (
                t_optim._flax_leaf(mod, pname),)
    return out


def jax_layout(v, path):
    v = np.asarray(v, np.float32)
    return v.T if path[-1] == "kernel" else v


@pytest.mark.parametrize("name", ["radam", "lars"])
@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_steps_match_optax(name, frozen):
    model = tiny_model()
    params = flax_tree(model)
    labels = jax.tree_util.tree_leaves(j_optim.param_labels(params))
    assert {"str", "str_nd", "kg", "perturb", "perturb_nd", "fusion",
            "fusion_nd", "decoder", "frozen"} <= set(labels)
    jax_step = (radam_steps if name == "radam" else lars_steps)(
        model, params, frozen)
    opt, sched = t_optim.create_optimizer(
        model, opt_cfg(t_config, name), warmup_epochs=WARMUP,
        total_epochs=STEPS, frozen_encoder=frozen)
    assert isinstance(opt, {"radam": t_optim.RAdam,
                            "lars": t_optim.LARS}[name])
    named = dict(model.named_parameters())
    rng = np.random.RandomState(1)
    moved = set()
    for step in range(STEPS):
        # float32 values, which both packages then hold exactly
        grads = {k: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-3, 0)
                     ).astype(np.float32).astype(np.float64)
                 for k, p in named.items()}
        want = jax_step(grads)
        before = {k: p.detach().clone() for k, p in named.items()}
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for k, p in named.items():
            got = (p.detach() - before[k]).numpy()
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got, want[k], rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=f"step {step} {k}")
            if scale > 0:
                moved.add(k)
    frozen_names = {"encoder.tx_encoder.drug_embeddings.weight"}
    if frozen:
        assert moved == {"decoder.weight"}
    else:
        assert moved == set(named) - frozen_names


def test_radam_threshold_and_lars_trust_ratio():
    """RAdam's rho first reaches 5 at step 6 with beta2 = 0.9, so the test
    above runs both branches; LARS leaves a zero-norm parameter's
    gradient unscaled."""
    rho_inf = 2 / (1 - 0.9) - 1
    rho = [rho_inf - 2 * t * 0.9 ** t / (1 - 0.9 ** t)
           for t in range(1, STEPS + 1)]
    assert max(rho[:5]) < 5 <= rho[5]
    p = nn.Parameter(torch.zeros(2, 2, dtype=torch.float64))
    p.grad = torch.ones(2, 2, dtype=torch.float64)
    t_optim.LARS([p], lr=0.1, weight_decay=0.5, momentum=0.0).step()
    np.testing.assert_allclose(p.detach().numpy(), -0.1)


def test_half_cycle_cosine_schedule_matches_jax():
    for step in range(14):
        np.testing.assert_allclose(
            t_optim.half_cycle_cosine_schedule(0.7, 4, 13)(step),
            float(j_optim.half_cycle_cosine_schedule(0.7, 4, 13)(step)),
            rtol=1e-6, atol=1e-9)  # JAX's is f32
