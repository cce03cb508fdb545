"""The port's checkpoint name maps and architecture builders against the JAX
package's: ``convert/sd_names.py`` (LDM <-> diffusers for the UNet and the
VAE, the legacy fused-qkv and conv layouts, OpenCLIP <-> transformers),
``convert/mmdit_names.py`` (SD3's sgm <-> diffusers), ``UNetConfig.sd21`` /
``from_ldm_config`` / ``from_sgm_config``, ``VAEConfig.from_ldm_config``,
``NoiseSchedule.from_ldm_config`` and ``conf.get_ldm_config`` / ``search_key``.

Name maps and converters are held bit for bit (the same keys, dtypes and
bytes from the same seeded numpy inputs), configs field for field. The
cases mirror tests/test_sd_name_map.py, tests/test_sd2_support.py and the
map cases of tests/test_sd3_single_file.py."""

import dataclasses

import numpy as np
import pytest
import torch

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.convert import mmdit_names as jmm
from scal_sdt_tpu.convert import sd_names as jnames
from scal_sdt_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from scal_sdt_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig, mmdit_param_shapes
from scal_sdt_tpu.models.unet import UNetConfig as JUNetConfig, unet_param_shapes
from scal_sdt_tpu.models.vae import VAEConfig as JVAEConfig, vae_param_shapes

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.convert import mmdit_names as tmm
from scal_sdt_tpu_torch.convert import sd_names as tnames
from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule as TSchedule
from scal_sdt_tpu_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from scal_sdt_tpu_torch.models.unet import UNetConfig as TUNetConfig
from scal_sdt_tpu_torch.models.vae import VAEConfig as TVAEConfig

from torch_port_helpers import rand_unet_params

def assert_same_state(got: dict, want: dict):
    """The port's dict of tensors equals JAX's dict of arrays: keys, dtypes,
    shapes and bytes."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).removeprefix("torch.") == {"float32": "float32", "float16": "float16",
                                                        "bfloat16": "bfloat16", "int32": "int32",
                                                        "int64": "int64"}[w.dtype.name], k
        gb = g.contiguous().view(torch.uint8).numpy() if g.dim() else (
            g.reshape(1).view(torch.uint8).numpy())
        assert gb.tobytes() == np.ascontiguousarray(w).tobytes(), k


def seeded(shapes: dict, seed: int = 0) -> tuple[dict, dict]:
    """The same seeded numpy state for both packages: (numpy, torch)."""
    state = rand_unet_params(shapes, seed)
    return state, {k: torch.from_numpy(v.copy()) for k, v in state.items()}


# --- UNet and VAE name maps (tests/test_sd_name_map.py) ------------------------

@pytest.mark.parametrize("arch", ["sd15", "sd21", "sdxl", "tiny"])
def test_unet_name_map_matches_jax(arch):
    jcfg, tcfg = getattr(JUNetConfig, arch)(), getattr(TUNetConfig, arch)()
    names = list(unet_param_shapes(jcfg))
    want = jnames.unet_name_map(jcfg, names)
    assert tnames.unet_name_map(tcfg, names) == want
    assert len(set(want.values())) == len(names)
    if arch in ("sd15", "sd21"):
        assert len(names) == 686
        # the SD1.5 pairs the JAX test checks
        assert want["up_blocks.1.upsamplers.0.conv.weight"] == "output_blocks.5.2.conv.weight"
        assert want["down_blocks.1.resnets.0.conv_shortcut.weight"] == \
            "input_blocks.4.0.skip_connection.weight"


@pytest.mark.parametrize("arch", ["sd15", "tiny"])
def test_vae_name_map_matches_jax(arch):
    jcfg, tcfg = getattr(JVAEConfig, arch)(), getattr(TVAEConfig, arch)()
    names = list(vae_param_shapes(jcfg))
    assert tnames.vae_prefix_map(tcfg) == jnames.vae_prefix_map(jcfg)
    want = jnames.vae_name_map(jcfg, names)
    assert tnames.vae_name_map(tcfg, names) == want
    if arch == "sd15":
        assert len(want) == len(set(want.values())) == 248
        assert want["encoder.mid_block.attentions.0.to_out.0.weight"] == \
            "encoder.mid.attn_1.proj_out.weight"


@pytest.mark.parametrize("arch", ["tiny", "tiny_sdxl"])
def test_unet_and_vae_state_round_trip_matches_jax(arch):
    """df -> LDM -> df of seeded states, UNet and VAE (the VAE's attention
    weights become 1x1 convs and back), bit for bit against JAX's."""
    jcfg, tcfg = getattr(JUNetConfig, arch)(), getattr(TUNetConfig, arch)()
    np_state, t_state = seeded(unet_param_shapes(jcfg))
    j_ldm = jnames.convert_unet_state_df_to_ldm(np_state, jcfg)
    t_ldm = tnames.convert_unet_state_df_to_ldm(t_state, tcfg)
    assert_same_state(t_ldm, j_ldm)
    assert_same_state(tnames.convert_unet_state_ldm_to_df(t_ldm, tcfg),
                      jnames.convert_unet_state_ldm_to_df(j_ldm, jcfg))

    np_vae, t_vae = seeded(vae_param_shapes(JVAEConfig.tiny()), 1)
    j_ldm = jnames.convert_vae_state_df_to_ldm(np_vae, JVAEConfig.tiny())
    t_ldm = tnames.convert_vae_state_df_to_ldm(t_vae, TVAEConfig.tiny())
    assert_same_state(t_ldm, j_ldm)
    assert t_ldm["encoder.mid.attn_1.q.weight"].dim() == 4
    back = tnames.convert_vae_state_ldm_to_df(t_ldm, TVAEConfig.tiny())
    assert_same_state(back, jnames.convert_vae_state_ldm_to_df(j_ldm, JVAEConfig.tiny()))
    assert_same_state(back, np_vae)


def test_strict_conversion_refuses_what_the_layout_does_not_consume():
    np_state, t_state = seeded(unet_param_shapes(JUNetConfig.tiny()))
    t_ldm = tnames.convert_unet_state_df_to_ldm(t_state, TUNetConfig.tiny())
    t_ldm["input_blocks.99.0.weight"] = torch.zeros(1)
    for conv, cfg in ((jnames.convert_unet_state_ldm_to_df, JUNetConfig.tiny()),
                      (tnames.convert_unet_state_ldm_to_df, TUNetConfig.tiny())):
        state = t_ldm if conv is tnames.convert_unet_state_ldm_to_df else \
            {k: v.numpy() for k, v in t_ldm.items()}
        with pytest.raises(ValueError, match="1 keys not consumed"):
            conv(state, cfg)
        assert len(conv(state, cfg, strict=False)) == len(np_state)
    vae = tnames.convert_vae_state_df_to_ldm(seeded(vae_param_shapes(JVAEConfig.tiny()))[1],
                                             TVAEConfig.tiny())
    # a standalone first stage's LPIPS tensors are skipped, others refused
    vae["loss.logvar"] = torch.zeros(())
    assert len(tnames.convert_vae_state_ldm_to_df(vae, TVAEConfig.tiny())) == len(vae) - 1
    vae["decoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="VAE state has 1 keys"):
        tnames.convert_vae_state_ldm_to_df(vae, TVAEConfig.tiny())


# --- legacy layouts -------------------------------------------------------------

def _legacy_unet_ldm(seed: int = 3) -> dict:
    """An LDM UNet state in the legacy CompVis AttentionBlock layout: every
    spatial attention's q/k/v fused into a 1-D conv ``qkv`` (rows
    interleaved per head, 8 channels per head as ``split_fused_qkv``
    assumes) and ``proj_out`` a 1-D conv."""
    np_state, _ = seeded(unet_param_shapes(JUNetConfig.tiny()), seed)
    ldm = jnames.convert_unet_state_df_to_ldm(np_state, JUNetConfig.tiny())
    r = np.random.RandomState(seed)
    out = dict(ldm)
    out["input_blocks.1.1.qkv.weight"] = r.randn(96, 32, 1).astype(np.float32)
    out["input_blocks.1.1.qkv.bias"] = r.randn(96).astype(np.float32)
    out["input_blocks.1.1.proj_out.weight"] = r.randn(32, 32, 1).astype(np.float32)
    return out


def test_split_fused_qkv_matches_jax():
    """The legacy fused ``qkv`` (1-D conv, per-head interleaved) splits into
    q/k/v linears, the 3-D ``proj_out`` becomes 2-D, bit for bit."""
    state = _legacy_unet_ldm()
    want = jnames.split_fused_qkv(state)
    got = tnames.split_fused_qkv({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    assert_same_state(got, want)
    assert tuple(got["input_blocks.1.1.q.weight"].shape) == (32, 32)
    assert tuple(got["input_blocks.1.1.proj_out.weight"].shape) == (32, 32)
    assert "input_blocks.1.1.qkv.weight" not in got


def test_legacy_diffusers_vae_names_match_jax():
    """query/key/value/proj_attn with 1x1-conv weights -> to_q/to_k/to_v/
    to_out.0 linear (C, C)."""
    np_state, _ = seeded(vae_param_shapes(JVAEConfig.tiny()), 4)
    legacy = {}
    for k, v in np_state.items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                         (".to_out.0.", ".proj_attn.")):
            if new in k:
                k = k.replace(new, old)
                v = v.reshape(*v.shape, 1, 1) if k.endswith(".weight") else v
                break
        legacy[k] = v
    want = jnames.normalize_df_vae_attention(legacy)
    got = tnames.normalize_df_vae_attention({k: torch.from_numpy(v.copy())
                                             for k, v in legacy.items()})
    assert_same_state(got, want)
    assert_same_state(got, np_state)


# --- OpenCLIP <-> transformers (tests/test_sd2_support.py) -------------------------

def _openclip(n_layers: int, d: int = 16, m: int = 32, seed: int = 5) -> dict:
    """A seeded OpenCLIP text tower: ``n_layers`` resblocks with fused
    in_proj, the projection and logit scale."""
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype(np.float32)
    state = {"token_embedding.weight": f(10, d), "positional_embedding": f(77, d),
             "ln_final.weight": f(d), "ln_final.bias": f(d), "text_projection": f(d, 12),
             "logit_scale": np.asarray(4.6, np.float32)}
    for i in range(n_layers):
        pre = f"transformer.resblocks.{i}"
        state.update({f"{pre}.attn.in_proj_weight": f(3 * d, d),
                      f"{pre}.attn.in_proj_bias": f(3 * d),
                      f"{pre}.attn.out_proj.weight": f(d, d), f"{pre}.attn.out_proj.bias": f(d),
                      f"{pre}.mlp.c_fc.weight": f(m, d), f"{pre}.mlp.c_fc.bias": f(m),
                      f"{pre}.mlp.c_proj.weight": f(d, m), f"{pre}.mlp.c_proj.bias": f(d)})
        for ln in ("ln_1", "ln_2"):
            state.update({f"{pre}.{ln}.weight": f(d), f"{pre}.{ln}.bias": f(d)})
    return state


@pytest.mark.parametrize("n_layers,keep_projection", [(2, False), (2, True), (24, False)])
def test_openclip_conversions_match_jax(n_layers, keep_projection):
    """OpenCLIP -> transformers (in_proj split row-wise into thirds, the last
    of exactly 24 resblocks dropped, SDXL's projection kept as a Linear
    weight) and back, bit for bit against JAX's; 23 layers stay 23."""
    oc = _openclip(n_layers)
    t_oc = {k: torch.from_numpy(v.copy()) for k, v in oc.items()}
    want = jnames.convert_openclip_text_to_transformers(oc, keep_projection=keep_projection)
    got = tnames.convert_openclip_text_to_transformers(t_oc, keep_projection=keep_projection)
    assert_same_state(got, want)
    kept = 23 if n_layers == 24 else n_layers
    assert f"text_model.encoder.layers.{kept - 1}.layer_norm1.weight" in got
    assert f"text_model.encoder.layers.{kept}.layer_norm1.weight" not in got
    assert ("text_projection.weight" in got) == keep_projection

    back_want = jnames.convert_transformers_text_to_openclip(want)
    back = tnames.convert_transformers_text_to_openclip(got)
    assert_same_state(back, back_want)
    again = tnames.convert_openclip_text_to_transformers(back, keep_projection=keep_projection)
    assert_same_state(again, want)   # a 23-layer tower prunes back out with 23
    with pytest.raises(ValueError, match="unconsumed"):
        tnames.convert_openclip_text_to_transformers({**t_oc, "extra": torch.zeros(1)})


# --- configs --------------------------------------------------------------------

SD2_LDM = {"model": {"params": {
    "timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012,
    "parameterization": "v",
    "unet_config": {"params": {
        "model_channels": 320, "channel_mult": [1, 2, 4, 4], "num_res_blocks": 2,
        "in_channels": 4, "out_channels": 4, "attention_resolutions": [4, 2, 1],
        "context_dim": 1024, "num_head_channels": 64, "use_linear_in_transformer": True}},
    "first_stage_config": {"params": {"ddconfig": {
        "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2, "in_channels": 3,
        "out_ch": 3, "z_channels": 4}}},
}}}

SGM = {"model": {"params": {
    "network_config": {"params": {
        "adm_in_channels": 80, "num_classes": "sequential", "in_channels": 4,
        "out_channels": 4, "model_channels": 32, "attention_resolutions": [2],
        "num_res_blocks": 1, "channel_mult": [1, 2], "num_head_channels": 16,
        "use_linear_in_transformer": True, "transformer_depth": [1, 2], "context_dim": 64,
        "num_groups": 8, "addition_time_embed_dim": 8}},
    "first_stage_config": {"params": {"ddconfig": {
        "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "in_channels": 3, "out_ch": 3,
        "z_channels": 4, "num_groups": 8}}},
}}}


@pytest.mark.parametrize("source", ["bundled_v1", "url", "sd2_yaml", "sgm_yaml"])
def test_architecture_configs_match_jax(source, tmp_path):
    """UNetConfig / VAEConfig / NoiseSchedule from the bundled v1 YAML (None
    or a URL), an SD2-v YAML file and an sgm YAML, field for field. The SD2
    YAML's ``parameterization: v`` is not read by either package: the
    schedule stays epsilon."""
    if source in ("bundled_v1", "url"):
        arg = None if source == "bundled_v1" else "https://example.invalid/v1-inference.yaml"
        jl, tl = jconf.get_ldm_config(arg), tconf.get_ldm_config(arg)
        assert jl == tl
        assert tconf.LDM_CONFIG_DIR.name == "ldm"
    else:
        path = tmp_path / "arch.yaml"
        tconf.save(tconf.Config(SD2_LDM if source == "sd2_yaml" else SGM), path)
        jl, tl = jconf.get_ldm_config(str(path)), tconf.get_ldm_config(str(path))
    builder = "from_sgm_config" if source == "sgm_yaml" else "from_ldm_config"
    got, want = getattr(TUNetConfig, builder)(tl), getattr(JUNetConfig, builder)(jl)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(TVAEConfig.from_ldm_config(tl)) == \
        dataclasses.asdict(JVAEConfig.from_ldm_config(jl))
    if source == "sgm_yaml":
        assert got == dataclasses.replace(TUNetConfig.tiny_sdxl(), sample_size=64)
        return
    ts, js = TSchedule.from_ldm_config(tl), JSchedule.from_ldm_config(jl)
    assert (ts.num_train_timesteps, ts.beta_start, ts.beta_end, ts.prediction_type) == \
        (js.num_train_timesteps, js.beta_start, js.beta_end, js.prediction_type) == \
        (1000, 0.00085, 0.012, "epsilon")
    if source == "sd2_yaml":
        assert got == TUNetConfig.sd21()
        assert TSchedule.from_ldm_config(tl, prediction_type="v").prediction_type == "v"
    else:
        assert got == TUNetConfig.sd15()


def test_sd21_config_and_shapes_match_jax():
    from scal_sdt_tpu_torch.models.unet import unet_param_shapes as t_shapes

    assert dataclasses.asdict(TUNetConfig.sd21()) == dataclasses.asdict(JUNetConfig.sd21())
    assert t_shapes(TUNetConfig.sd21()) == unet_param_shapes(JUNetConfig.sd21())
    shapes = t_shapes(TUNetConfig.sd21())
    assert shapes["down_blocks.0.attentions.0.proj_in.weight"] == (320, 320)
    to_k = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    assert shapes[to_k] == (320, 1024)
    cfg = TUNetConfig.sd21()
    assert [c // cfg.heads_at(i) for i, c in enumerate(cfg.block_out_channels)] == [64] * 4


def test_search_key_matches_jax():
    spec = {"lora": {"rank": 4, "alpha": 2},
            "unet": {"targets": [{"index": ["a"], "lora": {"rank": 8, "alpha": 3}}]},
            "text_encoder": [{"lora": {"alpha": 5}}]}
    got = list(tconf.search_key(tconf.Config(spec), "lora"))
    assert got == list(jconf.search_key(jconf.Config(spec), "lora"))
    assert [g.get("alpha") for g in got] == [2, 3, 5]


# --- MMDiT sgm <-> diffusers (tests/test_sd3_single_file.py) ------------------------

def _mmdit_config(**kw) -> dict:
    """Head dim 64, so the sgm shapes give the head count back."""
    return {**dict(sample_size=8, patch_size=2, in_channels=4, out_channels=4, num_layers=2,
                   attention_head_dim=64, num_attention_heads=2, joint_attention_dim=32,
                   pooled_projection_dim=24, pos_embed_max_size=12), **kw}


@pytest.mark.parametrize("case", ["plain", "rms_norm", "dual_attention"])
def test_mmdit_sgm_round_trip_matches_jax(case):
    """diffusers -> sgm (qkv fused, the two continuous adaLN heads' halves
    swapped) -> diffusers, and the config read back from the sgm shapes,
    against JAX's bit for bit and field for field."""
    kw = {"qk_norm": None if case == "plain" else "rms_norm"}
    if case == "dual_attention":
        kw.update(num_layers=3, dual_attention_layers=(0, 1))
    cfg = _mmdit_config(**kw)
    np_state, t_state = seeded(mmdit_param_shapes(JMMDiTConfig(**cfg)), 6)
    j_sgm = jmm.convert_mmdit_state_df_to_sgm(np_state)
    t_sgm = tmm.convert_mmdit_state_df_to_sgm(t_state)
    assert_same_state(t_sgm, j_sgm)
    d = 128
    # the semantic swap: sgm's first half is diffusers' second
    np.testing.assert_array_equal(t_sgm["final_layer.adaLN_modulation.1.weight"][:d].numpy(),
                                  np_state["norm_out.linear.weight"][d:])
    last = cfg["num_layers"] - 1
    np.testing.assert_array_equal(
        t_sgm[f"joint_blocks.{last}.context_block.adaLN_modulation.1.weight"][:d].numpy(),
        np_state[f"transformer_blocks.{last}.norm1_context.linear.weight"][d:])
    np.testing.assert_array_equal(   # the 6-chunk heads copy straight through
        t_sgm["joint_blocks.0.context_block.adaLN_modulation.1.weight"].numpy(),
        np_state["transformer_blocks.0.norm1_context.linear.weight"])
    back = tmm.convert_mmdit_state_sgm_to_df(t_sgm)
    assert_same_state(back, jmm.convert_mmdit_state_sgm_to_df(j_sgm))
    assert_same_state(back, np_state)

    got = tmm.mmdit_config_from_sgm_state(t_sgm)
    want = jmm.mmdit_config_from_sgm_state(j_sgm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == TMMDiTConfig(**{**cfg, "sample_size": got.sample_size})
    # the width the config reads from shapes alone: a trainable-only state
    partial = {k: v for k, v in t_state.items() if "norm1_context.linear.bias" in k}
    assert tmm._infer_inner_dim(partial) == jmm._infer_inner_dim(
        {k: v.numpy() for k, v in partial.items()}) is None
    ff_only = {k: v for k, v in t_state.items() if k.endswith("ff.net.2.weight")}
    assert tmm._infer_inner_dim(ff_only) == d


def test_mmdit_config_inference_refusals_match_jax():
    np_state, t_state = seeded(mmdit_param_shapes(JMMDiTConfig(**_mmdit_config())), 7)
    t_sgm = tmm.convert_mmdit_state_df_to_sgm(t_state)
    j_sgm = jmm.convert_mmdit_state_df_to_sgm(np_state)
    for fn, state in ((tmm.mmdit_config_from_sgm_state, t_sgm),
                      (jmm.mmdit_config_from_sgm_state, j_sgm)):
        with pytest.raises(ValueError, match="not divisible by head_dim"):
            fn(state, head_dim=48)
        with pytest.raises(ValueError, match="conflicts"):
            fn(state, pos_embed_max_size=16)
        no_pos = {k: v for k, v in state.items() if k != "pos_embed"}
        assert fn(no_pos).pos_embed_max_size == 192
        assert fn(no_pos, pos_embed_max_size=16).pos_embed_max_size == 16
    with pytest.raises(ValueError, match="Partial fused-qkv"):
        tmm.convert_mmdit_state_df_to_sgm(
            {k: v for k, v in t_state.items() if not k.endswith("attn.to_q.weight")})
    with pytest.raises(ValueError, match="unconsumed"):
        tmm.convert_mmdit_state_sgm_to_df({**t_sgm, "extra": torch.zeros(1)})


SD21_UNET_JSON = {
    "in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280, 1280],
    "layers_per_block": 2, "attention_head_dim": [5, 10, 20, 20],
    "use_linear_projection": True, "cross_attention_dim": 1024,
    "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "CrossAttnUpBlock2D"],
    "norm_num_groups": 32, "sample_size": 96}


def test_sd21_diffusers_configs_match_jax():
    """SD2.1's diffusers unet/config.json (per-level head counts under
    attention_head_dim) and its gelu text encoder, parsed field for field
    as the JAX loader parses them (tests/test_sd2_support.py)."""
    from scal_sdt_tpu.convert import loader as jloader
    from scal_sdt_tpu_torch.convert import loader as tloader

    got = tloader._unet_config_from_df(SD21_UNET_JSON)
    want = jloader._unet_config_from_df(SD21_UNET_JSON)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == dataclasses.replace(TUNetConfig.sd21(), sample_size=96)
    te = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 23,
          "num_attention_heads": 16, "hidden_act": "gelu"}
    assert dataclasses.asdict(tloader._clip_config_from_df(te)) == \
        dataclasses.asdict(jloader._clip_config_from_df(te))
    assert tloader._clip_config_from_df(te).hidden_act == "gelu"
