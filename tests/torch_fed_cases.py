"""Shared cases of the federated-runtime parity tests
(``tests/test_torch_fed.py``): the round configurations, the stub model api
both runtimes train, and two entry points run in subprocesses.

The stub api's ``loss_train`` is ``sum_leaves sum(w * k * c_leaf)`` with a
bf16-exact constant ``c_leaf`` per leaf and ``k`` in {1, 2, 3} read from
the batch's first token, so its gradient ``k * c_leaf`` is exact in bf16
and the same in both packages: both runtimes then train identical worker
params, and a round's difference comes from the aggregation alone.

    python -m tests.torch_fed_cases reference OUT.npz [families]
        the JAX package's rounds on a (2, 1, 1) CPU mesh, every case of
        CASES, or of FAMILY_CASES with ``families`` (imports jax; sets the
        host device count first);
    python -m tests.torch_fed_cases rank RANK PORT OUT.npz
        one gloo rank of two running every DIST_CASES case through
        ``DistTransport`` (imports no jax).
"""
import contextlib
import os
import sys

import numpy as np

FL, GAMMA = 2, 0.05
#: the smallest ArchConfig the elias case runs at (the JAX package's
#: sequential Elias decode at qwen3-smoke's 1.3 M coordinates takes minutes)
TINY = dict(name="tiny", family="dense", citation="test", n_layers=1,
            d_model=32, n_heads=2, n_kv=1, d_ff=64, vocab=64, d_head=16,
            pattern=("attn",), qk_norm=True, rope_theta=1e4)
_Q = dict(Kn=(1, 2), s0=64, sn=(16, 127))
_Q7 = dict(Kn=(1, 2), s0=7, sn=(7, 5))
_W = (0.7, 0.3)
_U = (1.5, 0.5)

#: name -> (FedConfig kwargs, tree: "stub" | "tiny" | an arch of ARCHS,
#: api: "stub" | "real", u)
CASES = {
    "f32": (dict(_Q, wire="f32"), "stub", "stub", None),
    "int8": (dict(_Q, wire="int8"), "stub", "stub", None),
    "rs_ag": (dict(_Q, wire="rs_ag"), "stub", "stub", None),
    "int4": (dict(_Q7, wire="int4"), "stub", "stub", None),
    "int8_b8": (dict(_Q, wire="int8", bucket=8), "stub", "stub", None),
    "rs_ag_b8": (dict(_Q, wire="rs_ag", bucket=8), "stub", "stub", None),
    "int4_b8": (dict(_Q7, wire="int4", bucket=8), "stub", "stub", None),
    "f32_u": (dict(_Q, wire="f32"), "stub", "stub", _U),
    "int8_b8_u": (dict(_Q, wire="int8", bucket=8), "stub", "stub", _U),
    "int8_w": (dict(_Q, wire="int8", agg_weights=_W), "stub", "stub", None),
    "momentum": (dict(_Q, wire="f32", agg_weights=_W, momentum=0.5,
                      normalize=True), "stub", "stub", None),
    "micro": (dict(_Q, wire="f32", microbatch=2), "stub", "stub", None),
    "real": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32"), "qwen", "real",
             None),
    "elias": (dict(Kn=(1, 2), s0=7, sn=(5, 7), wire="elias"), "tiny",
              "stub", None),
}
#: the rounds at the MoE, hybrid, xLSTM, VLM and whisper smoke configs:
#: the real loss (the router's aux term included; the VLM's at
#: ``microbatch`` 2, so positions3 (3, B, S) is split on its batch axis;
#: whisper's with f32 frames, also at ``microbatch`` 2, the frames (B, F,
#: D) split on axis 0) with exact workers and server, and the stub loss on
#: the same trees through the int8 wire (the aggregation alone); their
#: reference runs in a subprocess of its own
FAMILY_CASES = {
    "olmoe": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32"), "olmoe",
              "real", None),
    "olmoe_int8": (dict(_Q, wire="int8"), "olmoe", "stub", None),
    "zamba2": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32"), "zamba2",
               "real", None),
    "zamba2_int8": (dict(_Q, wire="int8"), "zamba2", "stub", None),
    "xlstm": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32"), "xlstm",
              "real", None),
    "xlstm_int8": (dict(_Q, wire="int8"), "xlstm", "stub", None),
    "qwen2vl_micro": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32",
                           microbatch=2), "qwen2vl", "real", None),
    "qwen2vl_int8": (dict(_Q, wire="int8"), "qwen2vl", "stub", None),
    "whisper": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32"), "whisper",
                "real", None),
    "whisper_int8": (dict(_Q, wire="int8"), "whisper", "stub", None),
    "whisper_micro": (dict(Kn=(1, 2), s0=None, sn=None, wire="f32",
                           microbatch=2), "whisper", "real", None),
}
#: tree name -> the arch whose smoke config it is
ARCHS = {"stub": "qwen3-1.7b", "qwen": "qwen3-1.7b", "olmoe": "olmoe-1b-7b",
         "zamba2": "zamba2-2.7b", "xlstm": "xlstm-1.3b",
         "qwen2vl": "qwen2-vl-7b", "whisper": "whisper-tiny"}
#: cases run in the port only, each held bitwise against a case of another
#: wire at the same quantizers (the reference's rounds are keyed by "f32")
PORT_ONLY = {
    "f32_s7": (dict(_Q7, wire="f32"), "stub", "stub", None),
    "f32_b8": (dict(_Q, wire="f32", bucket=8), "stub", "stub", None),
    "f32_b8_u": (dict(_Q, wire="f32", bucket=8), "stub", "stub", _U),
    "rs_ag_w": (dict(_Q, wire="rs_ag", agg_weights=_W), "stub", "stub",
                None),
    "f32_tiny": (dict(Kn=(1, 2), s0=7, sn=(5, 7), wire="f32"), "tiny",
                 "stub", None),
}
#: (port case, port case) pairs that must agree bit for bit
SAME_BITS = (("f32", "int8"), ("f32", "rs_ag"), ("f32_s7", "int4"),
             ("f32_b8", "int8_b8"), ("f32_b8", "rs_ag_b8"),
             ("f32_b8_u", "int8_b8_u"), ("int8_w", "rs_ag_w"),
             ("f32_tiny", "elias"))
#: cases the two gloo ranks run through DistTransport, on the stub tree
DIST_CASES = {name: (fed, "stub", "stub", u) for name, (fed, _, _, u)
              in {**CASES, **PORT_ONLY}.items() if name not in ("real",)}


def stub_tree():
    """A nested tree whose insertion order is not the sorted one, with a
    leaf of 7 coordinates two workers do not divide (rs_ag's whole-sum
    fallback)."""
    rng = np.random.default_rng(7)

    def f(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)
    return {"w2": f(48, 40), "b": f(7),
            "blocks": [{"wz": f(3, 16, 24), "ln": f(24)}], "a": f(1000)}


def batch_for(fed: dict, cfg) -> dict:
    """(fl, K_max, B, S) tokens and next-token labels, NumPy-seeded; for a
    VLM also patch embeddings (fl, K_max, B, S // 4, D) and M-RoPE streams
    (fl, K_max, 3, B, S) = (t, t // 4, t % 4), t offset per row; for an
    encoder-decoder f32 frames (fl, K_max, B, max_source_positions, D)."""
    rng = np.random.default_rng(3)
    lead = (FL, max(fed["Kn"]))
    t = rng.integers(0, cfg.vocab, lead + (4, 33)).astype(np.int32)
    batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
    if cfg.family == "vlm":
        S = 32
        batch["patch_embeds"] = rng.standard_normal(
            lead + (4, int(S * cfg.vision_patches_frac), cfg.d_model)
        ).astype(np.float32)
        pos = np.arange(S) + rng.integers(0, 50, lead + (4, 1))
        batch["positions3"] = np.stack([pos, pos // 4, pos % 4],
                                       axis=2).astype(np.int32)
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            lead + (4, cfg.max_source_positions, cfg.d_model)
        ).astype(np.float32)
    return batch


def _coef(i: int) -> float:
    return (i % 7 + 1) / 8.0


def stub_loss_jax(params, cfg, batch, aux_weight=0.01):
    import jax
    import jax.numpy as jnp
    k = (batch["tokens"].reshape(-1)[0] % 3 + 1).astype(jnp.float32)
    return sum(jnp.sum(w.astype(jnp.float32) * (k * _coef(i)))
               for i, w in enumerate(jax.tree.leaves(params)))


def stub_loss_torch(params, cfg, batch, aux_weight=0.01):
    import torch
    from repro_torch.fed import tree_leaves
    k = (batch["tokens"].reshape(-1)[0] % 3 + 1).to(torch.float32)
    return sum(torch.sum(w.to(torch.float32) * (k * _coef(i)))
               for i, w in enumerate(tree_leaves(params)))


class StubApi:
    """A model api with only the ``loss_train`` the round calls."""

    def __init__(self, loss):
        self.loss_train = loss


def reference(out: str, families: bool = False) -> None:
    """Every CASES (or FAMILY_CASES) round through the JAX package's
    ``make_round_fn`` on a (fl=2, fsdp=1, tp=1) CPU mesh, saved with the
    initial params and the round keys' words.  Whisper's real loss traces
    its layers unrolled: under the runtime's bf16 view its layer scan
    refuses f32 frames (the carry turns f32 after the cross-attention)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.configs.base import ArchConfig
    from repro.fed.runtime import FedConfig, make_round_fn
    from repro.models import unroll
    from repro.models.registry import get_config, model_api

    mesh = make_mesh(np.array(jax.devices()).reshape(FL, 1, 1),
                     ("fl", "fsdp", "tp"))
    key = jax.random.PRNGKey(1)
    res = {"keys": np.asarray(jax.random.split(key, FL + 1))}
    cases = FAMILY_CASES if families else CASES
    cfgs = {t: get_config(a, smoke=True) for t, a in ARCHS.items()}
    cfgs["tiny"] = ArchConfig(**TINY)
    trees = {t: model_api(c).init_params(jax.random.PRNGKey(0), c)
             for t, c in cfgs.items()
             if t != "stub" and any(v[1] == t for v in cases.values())}
    trees["stub"] = jax.tree.map(jnp.asarray, stub_tree())
    for name, (fed_kw, tree, api, u) in cases.items():
        cfg, params = cfgs[tree], trees[tree]
        fed = FedConfig(n_workers=FL, **fed_kw)
        rnd = jax.jit(make_round_fn(
            model_api(cfg) if api == "real" else StubApi(stub_loss_jax),
            cfg, fed, mesh))
        batch = {k: jnp.asarray(v) for k, v in batch_for(fed_kw, cfg).items()}
        args = (params, batch, key, jnp.float32(GAMMA))
        if u is not None:
            args += (jnp.asarray(u, jnp.float32),)
        with (unroll.unrolled() if cfg.encdec and api == "real"
              else contextlib.nullcontext()):
            x_new, m = rnd(*args)
        res[f"{name}/x_new"] = np.concatenate(
            [np.asarray(l).reshape(-1) for l in jax.tree.leaves(x_new)])
        for k, v in m.items():
            res[f"{name}/m/{k}"] = np.asarray(v)
    for tree in trees:
        if tree == "stub":
            continue
        for i, l in enumerate(jax.tree.leaves(trees[tree])):
            res[f"{tree}/x/{i}"] = np.asarray(l)
    np.savez(out, **res)


def port_round(case, x_hat, keys, transport=None):
    """The port's round of one case -> (x_hat' flat f32 numpy, metrics as
    numpy)."""
    import torch
    from repro_torch.fed import FedConfig, make_round_fn, tree_leaves
    from repro_torch.models.registry import get_config, model_api
    fed_kw, tree, api, u = case
    if tree == "tiny":
        from repro_torch.configs.base import ArchConfig
        cfg = ArchConfig(**TINY)
    else:
        cfg = get_config(ARCHS[tree], smoke=True)
    fed = FedConfig(n_workers=FL, **fed_kw)
    rnd = make_round_fn(model_api(cfg) if api == "real"
                        else StubApi(stub_loss_torch), cfg, fed, transport)
    batch = {k: torch.from_numpy(v) for k, v in batch_for(fed_kw, cfg).items()}
    x_new, m = rnd(x_hat, batch, keys[:FL], keys[FL], GAMMA, u)
    flat = torch.cat([l.reshape(-1).to(torch.float32)
                      for l in tree_leaves(x_new)])
    return flat.numpy(), {k: v.numpy() for k, v in m.items()}


def stub_params():
    import torch
    from repro_torch.fed import tree_unflatten, tree_leaves
    t = stub_tree()
    return tree_unflatten(t, [torch.from_numpy(a) for a in tree_leaves(t)])


def rank(rank_: int, port: int, out: str) -> None:
    """One of two gloo ranks: every DIST_CASES round through DistTransport
    (rank r trains worker r), saved by each rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.fed import DistTransport
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank_, world_size=FL)
    try:
        keys = np.arange(2 * (FL + 1), dtype=np.uint32).reshape(FL + 1, 2)
        res = {}
        for name, case in DIST_CASES.items():
            flat, m = port_round(case, stub_params(), keys,
                                 DistTransport())
            res[f"{name}/x_new"] = flat
            for k, v in m.items():
                res[f"{name}/m/{k}"] = v
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2], families=sys.argv[3:] == ["families"])
    else:
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
