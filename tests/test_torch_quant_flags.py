"""The int8 and draft switches of the port's engine and server against the
reference's, on the same settings: each environment variable and each
checkpoint-gate marker in a tmp OPENHUSH_MODEL_DIR, every variable cleared
first.

- openhush_tpu_torch.utils.quant_flags agrees with
  openhush_tpu.utils.quant_flags;
- where the reference's WhisperEngine quantizes its decoder or encoder
  weights, the port's quantizes the same leaves (scales rtol 1e-6, int8
  levels within one on at most 1e-3 of the elements: the reference's /127
  may compile to a reciprocal multiply); where the reference loads a draft
  model, the port's loads the same one (random weights under
  allow_random_init, as the reference's), and where it loads none, neither
  does the port;
- where the reference's EngineServer allocates an int8 self-cache, the
  port's has int8 values and [L, B, T, H] scales, else its fp cache with
  [L, B, 1, 1] placeholders;
- where the reference turns none on (a variable's "0" over a marker
  included), the port builds on the weights as given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhush_tpu.models.whisper import model as jax_model
from openhush_tpu.models.whisper.config import CONFIGS
from openhush_tpu.runtime import engine as jax_engine
from openhush_tpu.runtime import server as jax_server
from openhush_tpu.utils import quant_flags as jax_flags
from openhush_tpu_torch.models.whisper import weights
from openhush_tpu_torch.runtime import engine, server
from openhush_tpu_torch.utils import quant_flags

CFG = CONFIGS["test"]
VARS = ("OPENHUSH_INT8_WEIGHTS", "OPENHUSH_INT8_RUNG",
        "OPENHUSH_INT8_ENCODER", "OPENHUSH_DRAFT_MODEL",
        "OPENHUSH_INT8_SELF_CACHE")
RUNG, ENCODER, SELF_CACHE = "int8_rung.ok", "int8_encoder.ok", \
    "int8_self_cache.ok"
# (environment, markers in the models dir)
SETTINGS = {
    "nothing": ({}, ()),
    "weights=1": ({"OPENHUSH_INT8_WEIGHTS": "1"}, ()),
    "weights=0 over the rung marker": ({"OPENHUSH_INT8_WEIGHTS": "0"},
                                       (RUNG,)),
    "rung=1": ({"OPENHUSH_INT8_RUNG": "1"}, ()),
    "rung marker": ({}, (RUNG,)),
    "rung=0 over its marker": ({"OPENHUSH_INT8_RUNG": "0"}, (RUNG,)),
    "encoder=1": ({"OPENHUSH_INT8_ENCODER": "1"}, ()),
    "encoder marker": ({}, (ENCODER,)),
    "encoder=0 over its marker": ({"OPENHUSH_INT8_ENCODER": "0"},
                                  (ENCODER,)),
    "draft model": ({"OPENHUSH_DRAFT_MODEL": "test-draft"}, ()),
    "self-cache=1": ({"OPENHUSH_INT8_SELF_CACHE": "1"}, ()),
    "self-cache marker": ({}, (SELF_CACHE,)),
    "self-cache=0 over its marker": ({"OPENHUSH_INT8_SELF_CACHE": "0"},
                                     (SELF_CACHE,)),
    "every variable 0 over every marker": (
        {"OPENHUSH_INT8_WEIGHTS": "0", "OPENHUSH_INT8_RUNG": "0",
         "OPENHUSH_INT8_ENCODER": "0", "OPENHUSH_INT8_SELF_CACHE": "0"},
        (RUNG, ENCODER, SELF_CACHE)),
}


@pytest.fixture(scope="module")
def weights_pair():
    jparams = jax_model.init_params(CFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    params = weights.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                       torch.float32, "cpu")
    return jparams, params


@pytest.fixture(params=list(SETTINGS))
def setting(request, monkeypatch, tmp_path):
    env, markers = SETTINGS[request.param]
    for name in VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for marker in markers:
        (tmp_path / marker).touch()
    return tmp_path


def _int8_leaves(layers) -> dict:
    return {name: w for name, w in layers.items() if isinstance(w, dict)}


def test_flags_agree_with_the_reference(setting):
    for model_dir in (None, str(setting)):
        assert (quant_flags.int8_rung_enabled(model_dir)
                == jax_flags.int8_rung_enabled(model_dir))
        assert (quant_flags.int8_encoder_enabled(model_dir)
                == jax_flags.int8_encoder_enabled(model_dir))
    assert (quant_flags.RUNG_MARKER, quant_flags.ENCODER_MARKER) == (
        jax_flags.RUNG_MARKER, jax_flags.ENCODER_MARKER)


def test_engine_refuses_what_the_reference_turns_on(setting, weights_pair):
    jparams, params = weights_pair
    ref = jax_engine.WhisperEngine("test", params=jparams,
                                   allow_random_init=True)
    eng = engine.WhisperEngine("test", params=params, allow_random_init=True,
                               device="cpu")
    if ref.draft_cfg is None:
        assert eng.draft_cfg is None and eng.draft_params is None
    else:
        assert eng.draft_cfg.name == ref.draft_cfg.name
        assert (eng.draft_params["decoder"]["layers"]["q_w"].shape
                == ref.draft_params["decoder"]["layers"]["q_w"].shape)
    quantized = False
    for part in ("decoder", "encoder"):
        ref_q = _int8_leaves(ref.params[part]["layers"])
        ours = _int8_leaves(eng.params[part]["layers"])
        assert set(ours) == set(ref_q), part
        quantized |= bool(ours)
        for name, w in ours.items():
            np.testing.assert_allclose(w["s"].numpy(),
                                       np.asarray(ref_q[name]["s"]),
                                       rtol=1e-6)
            d = np.abs(w["q"].numpy().astype(np.int32)
                       - np.asarray(ref_q[name]["q"]).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
    if not quantized:
        assert eng.params is params


def test_server_refuses_what_the_reference_turns_on(setting, weights_pair,
                                                    monkeypatch):
    jparams, params = weights_pair
    seen = []
    init_state = jax_server.EngineServer._init_device_state

    def spy(self, **kw):
        seen.append(kw["int8_self_cache"])
        return init_state(self, **kw)

    monkeypatch.setattr(jax_server.EngineServer, "_init_device_state", spy)
    jax_server.EngineServer(CFG, jparams, n_slots=2, dtype=jnp.float32,
                            max_decode_len=32)
    srv = server.EngineServer(CFG, params, n_slots=2, dtype=torch.float32,
                              max_decode_len=32)
    L, H = CFG.n_text_layer, CFG.n_text_head
    assert seen in ([True], [False]) and srv.n_slots == 2
    assert srv.int8_self_cache == seen[0]
    st = srv.state
    if seen == [True]:
        assert st.cache_k.dtype == st.cache_v.dtype == torch.int8
        assert st.cache_ks.shape == st.cache_vs.shape == (L, 2, 32, H)
    else:
        assert st.cache_k.dtype == torch.float32
        assert st.cache_ks.shape == st.cache_vs.shape == (L, 2, 1, 1)
