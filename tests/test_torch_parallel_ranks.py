"""Rank functions for tests/test_torch_parallel.py: what each rank of a
spawned gloo world computes on the CPU. Torch and the port only: a spawned
rank imports this module afresh, and must not import JAX.

`cases` runs every sharded case of the test file on a 2x2 mesh of four
ranks, from the inputs the test process wrote with pickle (numpy trees made
from seeds), and returns this rank's outputs as numpy for the test process
to assemble and hold against the JAX package and the port on one device.
It holds no test (its name keeps it beside the port's tests, as
tests/test_torch_cli_support.py).
"""

from __future__ import annotations

import dataclasses
import pickle

import torch

from openhush_tpu_torch.models.whisper import decoding, model, weights
from openhush_tpu_torch.models.whisper.config import (WhisperConfig,
                                                      get_config)
from openhush_tpu_torch.parallel import sharding as sh
from openhush_tpu_torch.runtime import batcher, beam_batcher
from openhush_tpu_torch.text.tokenizer import WhisperTokenizer
from openhush_tpu_torch.training import data, train
from openhush_tpu_torch.utils import checkpoint

# The sharded forward and training config: the reference's shardtest
# widths (4 heads, d 128) with a 1000-token vocabulary.
SHARD_CFG = WhisperConfig(
    name="shardtest", n_mels=80, n_audio_ctx=64,
    n_audio_state=128, n_audio_head=4, n_audio_layer=2,
    n_text_state=128, n_text_head=4, n_text_layer=2,
    n_vocab=1000, n_text_ctx=32, n_langs=99)
# finetune's config: tests/test_torch_training_data.py's.
FT_CFG = WhisperConfig(name="traintest", n_mels=80, n_audio_ctx=128,
                       n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                       n_text_state=64, n_text_head=2, n_text_layer=2,
                       n_vocab=51865, n_text_ctx=64, n_langs=99)
SERVE = get_config("test")
DRAFT = get_config("test-draft")
N_SLOTS, G, K = 4, 2, 3
TRAIN_STEPS = 4
# The row-parallel biases: added once, after the model reduce.
ROW_BIASES = ("o_b", "xo_b", "fc2_b")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def trimmed(ds, cfg):
    """Mel frames cut to the encoder's context (as the training-data tests
    do)."""
    orig = ds._encode_example

    def small(ex):
        m, t, g = orig(ex)
        return m[:, : 2 * cfg.n_audio_ctx], t, g
    ds._encode_example = small
    return ds


def serve_setup():
    """(prompt, suppress mask, blank token) of the serving cases."""
    tok = WhisperTokenizer(SERVE.n_langs)
    prompt = tok.sot_sequence("en", "transcribe")
    suppress = torch.from_numpy(decoding.build_suppress_mask(
        tok, SERVE, decoding.DecodingOptions()))
    return prompt, suppress, tok.encode(" ")[0]


def greedy(params, state, xkv, prompt, suppress, blank, slots, shard=None):
    """Admit `slots` (global indices) from window 0 of xkv, two steps of
    four tokens; with `shard` (mesh, n_slots) only this data rank's."""
    for slot in slots:
        local = slot if shard is None else sh.local_slot(shard[0], slot,
                                                            shard[1])
        if local is not None:
            batcher.admit(SERVE, params, state, local, xkv, prompt, True,
                          prompt_len=len(prompt))
    for _ in range(2):
        state = batcher.step(SERVE, params, state, suppress, inner_steps=4,
                             blank_token=blank)
    return state


def spec(params, draft, state, xkv, dxkv, prompt, suppress, blank, slots,
         shard=None):
    for slot in slots:
        local = slot if shard is None else sh.local_slot(shard[0], slot,
                                                            shard[1])
        if local is not None:
            batcher.admit(SERVE, params, state, local, xkv, prompt, True,
                          prompt_len=len(prompt), draft_cfg=DRAFT,
                          draft_params=draft, draft_xkv=dxkv)
    return batcher.spec_step(SERVE, params, DRAFT, draft, state, suppress,
                             k_spec=3, n_iters=3,
                             room_cap=SERVE.n_text_ctx - 1,
                             blank_token=blank)


def beam(params, state, xkv, prompt, suppress, blank, shard=None):
    for g in range(G):
        local = g if shard is None else sh.local_slot(shard[0], g, shard[1])
        if local is not None:
            beam_batcher.admit(SERVE, params, state, local, xkv, prompt,
                               True, prompt_len=len(prompt), max_new=16)
    for _ in range(2):
        state = beam_batcher.step(SERVE, params, state, suppress,
                                  inner_steps=4, blank_token=blank)
    return state


@dataclasses.dataclass
class BeamStateWithExtra(beam_batcher.BeamState):
    """A BeamState with a per-layer row buffer that shard_beam_state's
    field table lacks: the coverage guard must refuse it."""
    extra_k: torch.Tensor = None


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def cases(inputs_path: str) -> dict:
    """Every sharded case on this rank of a 2x2 mesh (four ranks)."""
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    model._GELU_MODE = "erf"
    out: dict = {}
    mesh = sh.create_mesh(2, "cpu")
    out["coordinate"] = mesh.coordinate
    shapes = [sh.create_mesh(2, "cpu", ranks=[0, 1]),
              sh.create_mesh(1, "cpu", ranks=[0]), sh.create_mesh(None, "cpu")]
    out["shapes"] = [(m.n_data, m.n_model, m.coordinate) for m in
                     [mesh] + shapes]

    with torch.no_grad():
        # The sharded forward and encode: the rank's rows and heads.
        p = sh.shard_params(inp["params"], mesh)
        rows = sh.data_sharding(mesh, 4)
        mel = torch.from_numpy(inp["mel"][rows])
        out["forward"] = model.forward(SHARD_CFG, p, mel, torch.from_numpy(
            inp["tokens"][rows])).numpy()
        out["encode"] = model.encode(SHARD_CFG, p, mel).numpy()
        # Three rows do not split over two data ranks: each encodes all.
        out["split3"] = _error(lambda: sh.data_sharding(mesh, 3))
        out["encode3"] = model.encode(SHARD_CFG, p, torch.from_numpy(
            inp["mel3"])).numpy()

        # bf16, the serving dtype (the row-parallel partials reduced in
        # fp32, rounded once), then the control: the row-parallel biases
        # counted twice, as a bias added on both ranks before the reduce
        # would be.
        pb = sh.shard_params(weights.from_numpy_params(
            inp["params"], torch.bfloat16, "cpu"), mesh)
        tokens = torch.from_numpy(inp["tokens"][rows])
        out["forward_bf16"] = model.forward(SHARD_CFG, pb, mel.bfloat16(),
                                            tokens).numpy()
        for part in ("encoder", "decoder"):
            layers = pb[part]["layers"]
            for name in set(ROW_BIASES) & set(layers):
                layers[name] *= 2
        out["forward_bf16_bias_twice"] = model.forward(
            SHARD_CFG, pb, mel.bfloat16(), tokens).numpy()

        # Restoring the checkpoint onto the mesh.
        restored = checkpoint.load_params(inp["npz"], mesh)
        whole = sh.shard_params(weights.load_npz(inp["npz"]), mesh)
        out["restore_equal"] = all(
            torch.equal(a, b) for a, b in zip(train.leaves(restored),
                                              train.leaves(whole)))
        out["restore_mesh"] = restored.mesh is mesh
        out["restore_q_w"] = tuple(restored["encoder"]["layers"]["q_w"].shape)
        out["reshard"] = _error(lambda: sh.shard_params(restored, mesh))

    # Training: the first step's loss, gradients and global norm, then the
    # losses and parameters of TRAIN_STEPS steps.
    tp = sh.shard_params(inp["train_params"], mesh)
    opt = train.make_optimizer(lr=1e-3, warmup_steps=1)
    state = opt.init(tp)
    batch = [torch.from_numpy(inp[k][rows]) for k in ("train_mel",
                                                      "train_tokens",
                                                      "train_targets")]
    losses = []
    for i in range(TRAIN_STEPS):
        loss, grads = train.value_and_grad(SHARD_CFG, tp, *batch)
        if i == 0:
            out["grads"] = [g.numpy().copy() for g in grads]
            out["gnorm"] = float(train.global_norm(grads, tp))
        opt.apply(tp, grads, state)
        losses.append(float(loss))
    out["losses"] = losses
    out["trained"] = numpy_tree(tp)

    # finetune on the mesh.
    ds = trimmed(data.WhisperDataset(data.load_manifest(inp["manifest"]),
                                     FT_CFG, batch_size=2, max_tokens=24,
                                     seed=1), FT_CFG)
    _, out["finetune"] = data.finetune(FT_CFG, inp["ft_params"], ds,
                                       epochs=2, lr=2e-3, mesh=mesh)

    with torch.no_grad():
        # Serving on the test config: slots and groups over data, heads
        # over model.
        sp = sh.shard_params(inp["serve_params"], mesh)
        prompt, suppress, blank = serve_setup()
        feats = model.encode(SERVE, sp, torch.from_numpy(inp["serve_mel"]))
        xkv = model.compute_cross_kv_quant(SERVE, sp, feats)
        out["full_cache"] = _error(lambda: model.decode(
            SERVE, sp, torch.tensor([prompt]), 0,
            model.init_kv_cache(SERVE, 1, device="cpu"), xkv))
        st = greedy(sp, sh.shard_slot_state(batcher.init_state(
            SERVE, N_SLOTS, dtype=torch.float32, device="cpu"), sp,
            N_SLOTS), xkv, prompt, suppress, blank, [1], (mesh, N_SLOTS))
        out["greedy"] = st.tokens.numpy()
        out["greedy_lp"] = st.sum_logprob.numpy()

        draft = weights.from_numpy_params(inp["draft_params"],
                                          torch.float32, "cpu")
        dxkv = model.compute_cross_kv_quant(DRAFT, draft, feats)
        st = spec(sp, draft, sh.shard_slot_state(batcher.init_state(
            SERVE, N_SLOTS, dtype=torch.float32, draft_cfg=DRAFT,
            device="cpu"), sp, N_SLOTS), xkv, dxkv, prompt, suppress,
            blank, [1, 2], (mesh, N_SLOTS))
        out["spec"] = st.tokens.numpy()

        bs = beam(sp, sh.shard_beam_state(beam_batcher.init_state(
            SERVE, G, K, dtype=torch.float32, max_len=32, device="cpu"),
            sp, G, K), xkv, prompt, suppress, blank, (mesh, G))
        out["beam"] = bs.tokens.numpy()
        out["beam_lp"] = bs.alive_lp.numpy()

        one = beam_batcher.init_state(SERVE, 1, K, max_len=32, device="cpu")
        out["straddle"] = _error(lambda: sh.shard_beam_state(one, sp, 1, K))
        two = beam_batcher.init_state(SERVE, G, K, max_len=32, device="cpu")
        extra = BeamStateWithExtra(
            **{f.name: getattr(two, f.name)
               for f in dataclasses.fields(two)},
            extra_k=torch.zeros(SERVE.n_text_layer, G * K, 4))
        out["guard"] = _error(lambda: sh.shard_beam_state(extra, sp, G, K))

        # The int8 decoder rung: its stack stays whole, and its steps run
        # with no collective.
        q8 = sh.shard_params(model.quantize_decoder_weights(
            weights.from_numpy_params(inp["serve_params"], torch.float32,
                                      "cpu")), mesh)
        layers = q8["decoder"]["layers"]
        out["int8_widths"] = (layers["q_w"]["q"].shape[-1],
                              layers["q_b"].shape[-1],
                              q8["encoder"]["layers"]["q_w"].shape[-1])
        feats8 = model.encode(SERVE, q8, torch.from_numpy(inp["serve_mel"]))
        xkv8 = model.compute_cross_kv_quant(SERVE, q8, feats8)
        st8 = sh.shard_slot_state(batcher.init_state(
            SERVE, N_SLOTS, dtype=torch.float32, device="cpu"), q8, N_SLOTS)
        out["int8_cache_width"] = st8.cache_k.shape[-1]
        calls = sh.all_reduce.calls
        st8 = greedy(q8, st8, xkv8, prompt, suppress, blank, [1],
                     (mesh, N_SLOTS))
        out["int8_reduces"] = sh.all_reduce.calls - calls
        out["int8"] = st8.tokens.numpy()
    return out
