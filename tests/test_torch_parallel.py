"""The port's multi-device path (openhush_tpu_torch.parallel) on the CPU:
a 2x2 (data, model) mesh of four spawned gloo ranks, held against the JAX
package's single-device functions (which tests/test_parallel.py holds equal
to their sharded runs) and against the port on one device.

The ranks run tests/test_torch_parallel_ranks.py (torch only) once for the
module, on inputs made here from numpy and JAX seeds; the references are
computed here while they run. Outputs are assembled from the ranks: batch
rows by data rank, sharded leaves by model rank, and every model rank's
tokens must equal its data rank's first (the lockstep a collective needs).

Tolerances: forward logits and encoder features 2e-4 absolute (the
reference's sharded tests'); the B=3 encode 1e-5 (its fallback test's);
training losses 1e-4 relative over 4 steps and the finetune's over its
steps (tests/test_torch_train.py's and test_torch_training_data.py's),
the parameters after 4 steps 1e-4 absolute (three Adam steps at lr 1e-3
move one by up to 3e-3);
the first step's gradients 1e-5 of the largest and its global norm 1e-5
relative against the port on one device; tokens exact, log-probabilities
and beam scores 2e-4; bf16 logits BF16_ATOL against the port's bf16 on one
device. Trap cases these catch: a gradient summed twice over `model`, the
mean of the data ranks' local losses (row 0 alone has ignored targets), a
clip norm that counts a replicated leaf once per model rank, and in bf16 a
row-parallel bias added on every model rank (the bf16 case's control)."""

import concurrent.futures
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import decoding as jax_decoding
from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import WhisperConfig as JaxConfig
from openhush_tpu.parallel import sharding as jax_sh
from openhush_tpu.runtime import batcher as jax_batcher
from openhush_tpu.runtime import beam_batcher as jax_beam_batcher
from openhush_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from openhush_tpu.training import train as jax_train
from openhush_tpu_torch.audio.wav import save_wav
from openhush_tpu_torch.models.whisper import model, weights
from openhush_tpu_torch.parallel import dryrun, sharding as sh, world
from openhush_tpu_torch.runtime import batcher, beam_batcher
from openhush_tpu_torch.training import data, train
from tests import test_torch_parallel_ranks as ranks

N_RANKS = 4                     # a 2x2 mesh: rank r at (r // 2, r % 2)
# bf16 logits, the mesh against one device: a reading of 7.5e-3 (logits up
# to 1.5, bf16 rounding each product's output in another order); the
# control reads 0.32.
BF16_ATOL = 3e-2


def _jcfg(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return weights.from_numpy_params(tree, torch.float32, "cpu")


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    """erf GELU in both packages; two intra-op threads here while the four
    ranks (one thread each) run beside the references."""
    jax_gelu, gelu = jax_model._GELU_MODE, model._GELU_MODE
    jax_model._GELU_MODE = model._GELU_MODE = "erf"
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax_model._GELU_MODE, model._GELU_MODE = jax_gelu, gelu


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    cfg = ranks.SHARD_CFG
    inp = {
        "params": _np(jax_model.init_params(_jcfg(cfg),
                                            jax.random.PRNGKey(1))),
        "mel": rng.standard_normal((4, 80, 2 * cfg.n_audio_ctx)
                                   ).astype(np.float32),
        "tokens": rng.integers(0, 1000, (4, 8)),
        "mel3": rng.standard_normal((3, 80, 2 * cfg.n_audio_ctx)
                                    ).astype(np.float32),
        "train_params": _np(jax_model.init_params(_jcfg(cfg),
                                                  jax.random.PRNGKey(0))),
        "train_mel": rng.standard_normal((4, 80, 2 * cfg.n_audio_ctx)
                                         ).astype(np.float32),
        "train_tokens": rng.integers(0, 1000, (4, 8)),
        "train_targets": rng.integers(0, 1000, (4, 8)),
        "ft_params": _np(jax_model.init_params(_jcfg(ranks.FT_CFG),
                                               jax.random.PRNGKey(0))),
        "serve_params": _np(jax_model.init_params(_jcfg(ranks.SERVE),
                                                  jax.random.PRNGKey(42))),
        "serve_mel": (np.random.default_rng(7).standard_normal(
            (1, 80, 3000)) * 0.5).astype(np.float32),
        "draft_params": _np(jax_model.init_params(_jcfg(ranks.DRAFT),
                                                  jax.random.PRNGKey(9))),
    }
    inp["train_targets"][0, -2:] = train.IGNORE_ID     # row 0 alone
    # Nonzero biases (init gives zeros), so a row-parallel bias added on
    # every model rank shows.
    for part in ("encoder", "decoder"):
        layers = inp["params"][part]["layers"]
        for name in [n for n in layers if n.endswith("_b")]:
            layers[name] = (0.1 * rng.standard_normal(layers[name].shape)
                            ).astype(np.float32)
    weights.save_npz(inp["params"], str(root / "m.npz"))
    inp["npz"] = str(root / "m.npz")
    lines = []
    for i, text in enumerate(["hello there", "good morning",
                              "testing one two", "final phrase"]):
        n = 16000 + 4000 * i
        tone = 0.2 * np.sin(2 * np.pi * (200 + 100 * i) * np.arange(n)
                            / 16000)
        save_wav(str(root / f"utt{i}.wav"), (
            tone + 0.01 * rng.standard_normal(n)).astype(np.float32))
        lines.append(f"utt{i}.wav\t{text}")
    (root / "manifest.tsv").write_text("\n".join(lines) + "\n")
    inp["manifest"] = str(root / "manifest.tsv")
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    return inp, str(root / "inputs.pkl")


@pytest.fixture(scope="module")
def running(inputs):
    """The four ranks, started before the references are computed."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(world.run_world, ranks.cases, N_RANKS, inputs[1],
                         device="cpu")
    yield future
    pool.shutdown(wait=True)


def _jax_serving(inp):
    """tests/test_parallel.py's serving runs on one device, on the same
    weights and mel: the greedy batcher (slot 1 of 4, two steps of four
    tokens), the spec batcher (slots 1 and 2, the 1-layer draft, one
    dispatch of three iterations), the beam batcher (G groups of K, two
    steps of four) and the int8-decoder rung's greedy run."""
    cfg, dcfg = _jcfg(ranks.SERVE), _jcfg(ranks.DRAFT)
    params = jax.tree.map(jnp.asarray, inp["serve_params"])
    draft = jax.tree.map(jnp.asarray, inp["draft_params"])
    tok = JaxTokenizer(cfg.n_langs)
    blank = tok.encode(" ")[0]
    feats = jax_model.encode(cfg, params, inp["serve_mel"])
    xkv_q = jax_model.compute_cross_kv_quant(cfg, params, feats)
    prompt = tok.sot_sequence("en", "transcribe")
    P = len(prompt)
    jprompt = jnp.asarray([prompt], jnp.int32)
    suppress = jnp.asarray(jax_decoding.build_suppress_mask(
        tok, cfg, jax_decoding.DecodingOptions()))

    def greedy(params, xkv):
        state = jax_batcher.init_state(cfg, n_slots=4, dtype=jnp.float32)
        state = jax_batcher.admit(cfg, params, state, jnp.int32(1), xkv,
                                  jprompt, jnp.asarray(True), prompt_len=P)
        for _ in range(2):
            state = jax_batcher.step(cfg, params, state, suppress,
                                     inner_steps=4, blank_token=blank)
        return state

    out = {}
    state = greedy(params, xkv_q)
    out["greedy"] = (np.asarray(state.tokens[1]),
                     float(state.sum_logprob[1]))
    dxkv = jax_model.compute_cross_kv_quant(dcfg, draft, feats)
    state = jax_batcher.init_state(cfg, n_slots=4, dtype=jnp.float32,
                                   draft_cfg=dcfg)
    for slot in (1, 2):
        state = jax_batcher.admit(cfg, params, state, jnp.int32(slot), xkv_q,
                                  jprompt, jnp.asarray(True), prompt_len=P,
                                  draft_cfg=dcfg, draft_params=draft,
                                  draft_xkv=dxkv)
    state = jax_batcher.spec_step(cfg, params, dcfg, draft, state, suppress,
                                  k_spec=3, n_iters=3,
                                  room_cap=cfg.n_text_ctx - 1,
                                  blank_token=blank)
    out["spec"] = np.asarray(state.tokens)
    bs = jax_beam_batcher.init_state(cfg, ranks.G, ranks.K,
                                     dtype=jnp.float32, max_len=32)
    for g in range(ranks.G):
        bs = jax_beam_batcher.admit(cfg, params, bs, jnp.int32(g), xkv_q,
                                    jprompt, jnp.asarray(True), prompt_len=P,
                                    max_new=jnp.int32(16))
    for _ in range(2):
        bs = jax_beam_batcher.step(cfg, params, bs, suppress, inner_steps=4,
                                   blank_token=blank)
    out["beam"], out["beam_lp"] = np.asarray(bs.tokens), np.asarray(
        bs.alive_lp)
    q8 = jax_model.quantize_decoder_weights(params)
    xkv8 = jax_model.compute_cross_kv_quant(
        cfg, q8, jax_model.encode(cfg, q8, inp["serve_mel"]))
    out["int8"] = np.asarray(greedy(q8, xkv8).tokens)
    return out


def _port_serving(inp):
    """The port's spec, beam and int8 runs on one device."""
    params = _t(inp["serve_params"])
    draft = _t(inp["draft_params"])
    prompt, suppress, blank = ranks.serve_setup()
    mel = torch.from_numpy(inp["serve_mel"])
    out = {}
    with torch.no_grad():
        feats = model.encode(ranks.SERVE, params, mel)
        xkv = model.compute_cross_kv_quant(ranks.SERVE, params, feats)
        dxkv = model.compute_cross_kv_quant(ranks.DRAFT, draft, feats)
        out["spec"] = ranks.spec(params, draft, batcher.init_state(
            ranks.SERVE, ranks.N_SLOTS, dtype=torch.float32,
            draft_cfg=ranks.DRAFT, device="cpu"), xkv, dxkv, prompt,
            suppress, blank, [1, 2]).tokens.numpy()
        bs = ranks.beam(params, beam_batcher.init_state(
            ranks.SERVE, ranks.G, ranks.K, dtype=torch.float32, max_len=32,
            device="cpu"), xkv, prompt, suppress, blank)
        out["beam"], out["beam_lp"] = bs.tokens.numpy(), bs.alive_lp.numpy()
        q8 = model.quantize_decoder_weights(params)
        xkv8 = model.compute_cross_kv_quant(
            ranks.SERVE, q8, model.encode(ranks.SERVE, q8, mel))
        out["int8"] = ranks.greedy(q8, batcher.init_state(
            ranks.SERVE, ranks.N_SLOTS, dtype=torch.float32, device="cpu"),
            xkv8, prompt, suppress, blank, [1]).tokens.numpy()
    return out


def _port_training(inp):
    """The port's first-step gradients and norm, and the finetune's
    losses, on one device."""
    cfg = ranks.SHARD_CFG
    params = _t(inp["train_params"])
    batch = [torch.from_numpy(inp[k]) for k in ("train_mel", "train_tokens",
                                                "train_targets")]
    loss, grads = train.value_and_grad(cfg, params, *batch)
    out = {"loss": float(loss), "grads": [g.numpy() for g in grads],
           "gnorm": float(train.global_norm(grads, params))}
    ds = ranks.trimmed(data.WhisperDataset(
        data.load_manifest(inp["manifest"]), ranks.FT_CFG, batch_size=2,
        max_tokens=24, seed=1), ranks.FT_CFG)
    _, out["finetune"] = data.finetune(ranks.FT_CFG, _t(inp["ft_params"]),
                                       ds, epochs=2, lr=2e-3)
    return out


def _port_bf16(inp):
    """The port's bf16 forward on one device."""
    params = weights.from_numpy_params(inp["params"], torch.bfloat16, "cpu")
    with torch.no_grad():
        return model.forward(ranks.SHARD_CFG, params, torch.from_numpy(
            inp["mel"]).bfloat16(), torch.from_numpy(inp["tokens"])).numpy()


def _jax_training(inp):
    cfg = _jcfg(ranks.SHARD_CFG)
    params = jax.tree.map(jnp.asarray, inp["params"])
    out = {"forward": np.asarray(jax_model.forward(
               cfg, params, inp["mel"], inp["tokens"].astype(np.int32))),
           "encode": np.asarray(jax_model.encode(cfg, params, inp["mel"])),
           "encode3": np.asarray(jax_model.encode(cfg, params, inp["mel3"]))}
    opt = jax_train.make_optimizer(lr=1e-3, warmup_steps=1)
    p = jax.tree.map(jnp.asarray, inp["train_params"])
    s = opt.init(p)
    losses = []
    for _ in range(ranks.TRAIN_STEPS):
        p, s, loss = jax_train.train_step(
            cfg, opt, p, s, jnp.asarray(inp["train_mel"]),
            jnp.asarray(inp["train_tokens"], jnp.int32),
            jnp.asarray(inp["train_targets"], jnp.int32))
        losses.append(float(loss))
    out["losses"], out["trained"] = losses, _np(p)
    return out


@pytest.fixture(scope="module")
def refs(inputs, running):
    inp = inputs[0]
    return {**_jax_training(inp), **_jax_serving(inp),
            "port_forward_bf16": _port_bf16(inp),
            **{f"port_{k}": v for k, v in _port_serving(inp).items()},
            **{f"port_{k}": v for k, v in _port_training(inp).items()}}


@pytest.fixture(scope="module")
def results(refs, running):
    return running.result()


def _rows(results, key):
    """A batch-split output: data ranks in order (model rank 0's), after
    checking that each data rank's model ranks agree."""
    for r in range(N_RANKS):
        np.testing.assert_array_equal(results[r][key],
                                      results[r - r % 2][key])
    return np.concatenate([results[0][key], results[2][key]])


def _whole(results, key, specs):
    """A leaf list (train.leaves order) assembled over the model axis;
    data rank 1 must hold data rank 0's values."""
    out = []
    for i, spec in enumerate(specs):
        for m in range(2):
            np.testing.assert_array_equal(results[2 + m][key][i],
                                          results[m][key][i])
        if sh.MODEL_AXIS in spec:
            out.append(np.concatenate([results[0][key][i],
                                       results[1][key][i]],
                                      axis=spec.index(sh.MODEL_AXIS)))
        else:
            out.append(results[0][key][i])
    return out


def test_create_mesh_shapes(results):
    for r, res in enumerate(results):
        d, m = divmod(r, 2)
        assert res["shapes"] == [
            (2, 2, (d, m)),                             # 2x2
            (1, 2, (0, r) if r < 2 else None),          # 1x2 on ranks 0, 1
            (1, 1, (0, 0) if r == 0 else None),         # 1x1 on rank 0
            (1, 4, (0, r))]                             # default: min(4, n)


def test_param_spec_rules(inputs):
    """The reference's rules on every leaf, with its named cases."""
    params = inputs[0]["params"]
    specs = sh.param_spec(params)
    enc = specs["encoder"]["layers"]
    assert enc["q_w"] == (None, None, "model")
    assert enc["o_w"] == (None, "model", None)
    assert enc["fc1_b"] == (None, "model")
    assert specs["decoder"]["tok_emb"] == ()
    assert specs["encoder"]["conv1_w"] == ()
    ref = jax.tree.leaves(jax_sh.param_spec(params),
                          is_leaf=lambda s: isinstance(s, tuple))
    assert [tuple(s) for s in ref] == train.leaves(specs)


def test_sharded_forward_and_encode_match_jax(results, refs):
    V = ranks.SHARD_CFG.n_vocab
    np.testing.assert_allclose(_rows(results, "forward")[..., :V],
                               refs["forward"][..., :V], atol=2e-4)
    np.testing.assert_allclose(_rows(results, "encode"), refs["encode"],
                               atol=2e-4)


def test_indivisible_batch_raises_or_runs_whole(results, refs):
    """B=3 over a data axis of 2 (the reference's fallback case): the data
    split raises with a clear message, and the whole batch on every data
    rank gives the single device's numbers."""
    assert results[0]["split3"].startswith("ValueError: a batch of 3 does "
                                           "not split")
    for res in results:
        np.testing.assert_allclose(res["encode3"], refs["encode3"],
                                   atol=1e-5)


def test_sharded_train_steps_match_jax(results, refs):
    """Four steps (lr 0 on the first) with row 0's last two targets
    ignored: the JAX package's losses, and its parameters after them."""
    for res in results:
        np.testing.assert_allclose(res["losses"], refs["losses"], rtol=1e-4)
    specs = train.leaves(sh.param_spec(refs["trained"]))
    ours = _whole([{"trained": train.leaves(r["trained"])} for r in results],
                  "trained", specs)
    for a, b in zip(ours, train.leaves(refs["trained"])):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_sharded_gradients_match_one_device(results, refs):
    """The first step's loss, gradients and clip norm against the port on
    one device (the clip is active: norm > 1)."""
    assert refs["port_gnorm"] > 1.0
    specs = train.leaves(sh.param_spec(refs["trained"]))
    for res in results:
        assert res["losses"][0] == pytest.approx(refs["port_loss"],
                                                 rel=1e-5)
        assert res["gnorm"] == pytest.approx(refs["port_gnorm"], rel=1e-5)
    for a, b in zip(_whole(results, "grads", specs), refs["port_grads"]):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(),
                                                         1e-3))


def test_greedy_batcher_matches_jax(results, refs):
    tokens, lp = refs["greedy"]
    ours = _rows(results, "greedy")
    np.testing.assert_array_equal(ours[1], tokens)
    assert _rows(results, "greedy_lp")[1] == pytest.approx(lp, abs=2e-4)


def test_spec_and_beam_batchers_match_one_device(results, refs):
    np.testing.assert_array_equal(_rows(results, "spec"), refs["port_spec"])
    np.testing.assert_array_equal(_rows(results, "beam"), refs["port_beam"])
    np.testing.assert_allclose(_rows(results, "beam_lp"),
                               refs["port_beam_lp"], atol=2e-4)


def test_spec_beam_and_int8_batchers_match_jax(results, refs):
    """The mesh's spec, beam and int8-rung runs against the JAX package's
    on one device: tokens exact, beam scores 2e-4."""
    np.testing.assert_array_equal(_rows(results, "spec"), refs["spec"])
    np.testing.assert_array_equal(_rows(results, "beam"), refs["beam"])
    np.testing.assert_allclose(_rows(results, "beam_lp"), refs["beam_lp"],
                               atol=2e-4)
    np.testing.assert_array_equal(_rows(results, "int8"), refs["int8"])


def test_sharded_bf16_forward_matches_one_device(results, refs):
    """bf16, the serving dtype: the mesh's logits within BF16_ATOL of the
    port's bf16 forward on one device, and the control, the row-parallel
    biases counted twice (a bias added on both model ranks before the
    reduce), outside it."""
    V = ranks.SHARD_CFG.n_vocab
    one = refs["port_forward_bf16"][..., :V]
    err = np.abs(_rows(results, "forward_bf16")[..., :V] - one).max()
    ctrl = np.abs(_rows(results, "forward_bf16_bias_twice")[..., :V]
                  - one).max()
    assert err <= BF16_ATOL < ctrl


def test_beam_state_straddle_and_coverage_guard(results):
    assert results[0]["straddle"].startswith("ValueError: n_groups=1 not "
                                             "divisible")
    assert "straddle" in results[0]["straddle"]
    assert results[0]["guard"].startswith("AssertionError: BeamState."
                                          "extra_k looks like")


def test_full_width_cache_is_refused_beside_sharded_params(results):
    assert results[0]["full_cache"].startswith(
        "ValueError: the self-cache holds 64 columns, the decoder 1 heads "
        "(32) on this rank")


def test_finetune_on_a_mesh_matches_one_device(results, refs):
    for res in results:
        assert len(res["finetune"]) == len(refs["port_finetune"]) == 4
        np.testing.assert_allclose(res["finetune"], refs["port_finetune"],
                                   rtol=1e-4)


def test_restore_onto_the_mesh(results):
    for res in results:
        assert res["restore_equal"] and res["restore_mesh"]
        assert res["restore_q_w"] == (2, 128, 64)
        assert res["reshard"].startswith("ValueError: these parameters are "
                                         "a rank's shard already")


def test_int8_decoder_stays_whole(results, refs):
    """The int8 rung's decoder stack is left whole (levels, scales and
    biases), its steps run no collective, and its tokens are one
    device's; the fp encoder is still sharded."""
    for res in results:
        assert res["int8_widths"] == (64, 64, 32)
        assert res["int8_cache_width"] == 64
        assert res["int8_reduces"] == 0
    np.testing.assert_array_equal(_rows(results, "int8"), refs["port_int8"])


def test_dryrun_multichip_prints_its_report(capsys):
    report = dryrun.dryrun_multichip(4, "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (
        "dryrun mesh 2x2 (data x model, 4 devices): "
        f"train(loss={report[0]['outputs']['loss']:.4f}) OK, "
        "sharded-flash-encode+prefill OK, greedy-batcher-step OK, "
        "spec-batcher-step OK, beam-batcher-step(G=2,K=3) OK")
    assert lines[1].startswith("dryrun mesh 2x2 against one rank: tokens "
                               "equal")
    assert lines[2].startswith("dryrun mesh 1x2 (data x model, 2 devices): ")
    assert lines[-1].startswith("dryrun_multichip OK: 4 devices; 2 mesh "
                                "shapes (2x2, 1x2)")


def test_create_mesh_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for entry in (sh.create_mesh, lambda: dryrun.dryrun_multichip(2),
                  lambda: world.run_world(ranks.cases, 2, "")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    with pytest.raises(RuntimeError, match="no process group"):
        sh.create_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        world.resolve_backend(torch.device("cuda"), 2)
    assert world.resolve_backend(torch.device("cuda"), 2, "gloo") == "gloo"
    with pytest.raises(ValueError, match="only gloo"):
        world.resolve_backend(torch.device("cpu"), 2, "nccl")
