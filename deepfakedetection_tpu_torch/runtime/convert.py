"""Weights into the port's models.

``state_dict_from_jax`` carries a JAX package ``{"params", "batch_stats"}``
tree (numpy leaves) into the port's state dict through the port's own name
maps, the counterparts of ``deepfakedetection_tpu/runtime/torch_convert.py``
(EfficientNet and EfficientFormerV2) and ``runtime/fastervit_convert.py``
(FasterViT): keys are the reference wheels' (efficientnet_pytorch; timm; the
fastervit wheel), layouts OIHW for convs, [out, in] for dense kernels and [g,
h, 1, 1] for EfficientFormerV2's talking heads. For FasterViT it covers both
head configurations: the tensors only the "tpu" one has (layer-scale gammas,
learned bias tables, learned position tables) get the port's own names.
``load_weights`` reads a genuine torch ``.pth``, or a native flax msgpack
export (the JAX package's ``checkpoints/<Model>.pth`` and its export's
``.weights.msgpack``, told apart by their first bytes as the JAX loader does)
through the port's own reader (``runtime/flax_msgpack.py``, no JAX) and
``state_dict_from_jax``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from deepfakedetection_tpu_torch.runtime import flax_msgpack

_WRAPPERS = ("state_dict", "model")

Path_ = tuple[str, ...]
# torch key -> (flax body path, layout kind: "auto" or "none")
NameMap = dict[str, tuple[Path_, str]]


def _flatten(tree: Any, prefix: Path_ = ()) -> dict[Path_, Any]:
    if not hasattr(tree, "items"):
        return {prefix: tree}
    out: dict[Path_, Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def _inverse_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    """flax -> torch: HWIO -> OIHW, [in, out] -> [out, in]; "talking_head":
    an einsum table [h, g] -> a 1x1 conv's weight [g, h, 1, 1]; "none" copies."""
    if kind == "none":
        return arr
    if kind == "talking_head":
        return arr.T[:, :, None, None]
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        return arr.T
    return arr


class _Map:
    """Builds a NameMap with the flax module conventions."""

    def __init__(self) -> None:
        self.m: NameMap = {}

    def __call__(self, key: str, path: Path_, kind: str = "none") -> None:
        self.m[key] = (path, kind)

    def bn(self, key: str, path: Path_) -> None:
        for t, f in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                     ("running_var", "var")):
            self(f"{key}.{t}", path + (f,))

    def ln(self, key: str, path: Path_) -> None:
        self(f"{key}.weight", path + ("scale",))
        self(f"{key}.bias", path + ("bias",))

    def dense(self, key: str, path: Path_, bias: bool = True) -> None:
        self(f"{key}.weight", path + ("kernel",), "auto")
        if bias:
            self(f"{key}.bias", path + ("bias",))


def _efficientnet_map(tops: set[str]) -> NameMap:
    """efficientnet_pytorch keys <- the flax EfficientNet (``stem``,
    ``stage{S}_block{R}``, ``head_conv``, ``classifier``); the flat torch
    block index follows the (stage, rep) order."""
    m = _Map()
    blocks = sorted((int(a), int(b)) for t in tops
                    for a, b in re.findall(r"^stage(\d+)_block(\d+)$", t))
    m("_conv_stem.weight", ("stem", "kernel"), "auto")
    m.bn("_bn0", ("stem",))
    for i, (stage, rep) in enumerate(blocks):
        b, f = f"_blocks.{i}", (f"stage{stage}_block{rep}",)
        m(f"{b}._expand_conv.weight", f + ("expand", "kernel"), "auto")
        m.bn(f"{b}._bn0", f + ("expand",))
        m(f"{b}._depthwise_conv.weight", f + ("depthwise", "kernel"), "auto")
        m.bn(f"{b}._bn1", f + ("depthwise",))
        m.dense(f"{b}._se_reduce", f + ("se", "reduce"))
        m.dense(f"{b}._se_expand", f + ("se", "expand"))
        m(f"{b}._project_conv.weight", f + ("project", "kernel"), "auto")
        m.bn(f"{b}._bn2", f + ("project",))
    m("_conv_head.weight", ("head_conv", "kernel"), "auto")
    m.bn("_bn1", ("head_conv",))
    m.dense("_fc", ("classifier",))
    return m.m


def _fastervit_map(tops: set[str], plain: frozenset[str] = frozenset()) -> NameMap:
    """fastervit wheel keys <- the flax FasterViT. The flax model downsamples
    at a stage's start (``downsample_{s}``), the wheel at the previous
    level's end (``levels.{s-1}.downsample``). The CT tokenizer's depthwise
    conv is registered under two names in the wheel; both are emitted. A
    stage-2 block in ``plain`` (the degenerate stage 3 of an input whose
    stage-3 map is one window or less: its flax block holds ``blk``, not
    ``hat``/``win``) maps as the stage-4 ``PlainBlock``s do, to
    ``levels.2.blocks.{b}.*``; the wheel has no such blocks, and the port's
    model names them so."""
    m = _Map()

    def cpb(key: str, path: Path_) -> None:
        m.dense(f"{key}.cpb_mlp.0", path + ("cpb_fc1",))
        m.dense(f"{key}.cpb_mlp.2", path + ("cpb_fc2",), bias=False)

    def subblock(key: str, path: Path_, gammas: tuple[str, str]) -> None:
        """A flax TransformerSubBlock: ``key`` ends in the separator, so the
        carrier-token sub-block passes "...hat_"."""
        m.ln(f"{key}norm1", path + ("norm1",))
        m.dense(f"{key}attn.qkv", path + ("attn", "qkv"))
        m.dense(f"{key}attn.proj", path + ("attn", "proj"))
        cpb(f"{key}attn.pos_emb_funct", path + ("attn", "pos_emb_funct"))
        m(f"{key}attn.rel_bias", path + ("attn", "rel_bias"))
        m.ln(f"{key}norm2", path + ("norm2",))
        m.dense(f"{key}mlp.fc1", path + ("mlp", "fc1"))
        m.dense(f"{key}mlp.fc2", path + ("mlp", "fc2"))
        m(f"{key}{gammas[0]}", path + ("attn_gamma",))
        m(f"{key}{gammas[1]}", path + ("mlp_gamma",))

    for i, s in ((0, "stem_0"), (3, "stem_1")):
        m(f"patch_embed.conv_down.{i}.weight", (s, "kernel"), "auto")
        m.bn(f"patch_embed.conv_down.{i + 1}", (s,))
    for t in tops:
        hit = re.match(r"^stage([01])_block(\d+)$", t)
        if hit:
            b = f"levels.{hit.group(1)}.blocks.{hit.group(2)}"
            for n in ("1", "2"):
                m(f"{b}.conv{n}.weight", (t, f"conv{n}", "kernel"), "auto")
                m(f"{b}.conv{n}.bias", (t, f"conv{n}", "conv_bias"))
                m.bn(f"{b}.norm{n}", (t, f"conv{n}"))
            m(f"{b}.gamma", (t, "gamma"))
        hit = re.match(r"^stage([23])_block(\d+)$", t)
        if hit:
            b = f"levels.{hit.group(1)}.blocks.{hit.group(2)}."
            cpb(f"{b}pos_embed", (t, "pos_embed"))
            if hit.group(1) == "2" and t not in plain:  # HAT: carrier-token and window sub-blocks
                cpb(f"{b}hat_pos_embed", (t, "hat_pos_embed"))
                subblock(f"{b}hat_", (t, "hat"), ("gamma1", "gamma2"))
                subblock(b, (t, "win"), ("gamma1", "gamma2"))
            else:
                subblock(b, (t, "blk"), ("gamma1", "gamma2"))
    for s in (1, 2, 3):
        m.ln(f"levels.{s - 1}.downsample.norm", (f"downsample_{s}", "norm"))
        m(f"levels.{s - 1}.downsample.reduction.0.weight",
          (f"downsample_{s}", "conv", "kernel"), "auto")
    for alias in ("pos_embed", "to_global_feature.pos"):
        m.dense(f"levels.2.global_tokenizer.{alias}", ("ct_tokenizer_pos",))
    m("levels.2.ct_pos_embed", ("ct_pos_embed",))
    m("levels.2.win_pos_embed", ("win_pos_embed",))
    m("levels.3.pos_embed_table", ("stage3_pos_embed",))
    m.bn("norm", ("norm_out",))
    m.dense("head", ("head",))
    return m.m


def _efficientformer_v2_map(tops: set[str]) -> NameMap:
    """timm ``efficientformerv2_*`` keys <- the flax EfficientFormerV2
    (``stem_{0,1}``, ``downsample_{s}``, ``stages_{s}_block{b}_{attn,
    attn_res,ffn,ffn_res}``, ``norm_out``, ``head``, ``head_dist``); a
    ConvNorm is ``.conv`` + ``.bn``. The output projection is spelled
    ``proj`` (the port's model also reads timm's older ``proj.1``)."""
    m = _Map()

    def convbn(key: str, path: Path_) -> None:
        m(f"{key}.conv.weight", path + ("kernel",), "auto")
        m.bn(f"{key}.bn", path)

    convbn("stem.conv1", ("stem_0",))
    convbn("stem.conv2", ("stem_1",))
    convbn("stages.1.downsample.conv", ("downsample_1",))
    for s in (2, 3):
        d, f = f"stages.{s}.downsample", f"downsample_{s}"
        convbn(f"{d}.conv", (f, "conv"))
        m(f"{d}.attn.q.local.weight", (f, "q_local", "kernel"), "auto")
        m(f"{d}.attn.q.local.bias", (f, "q_local", "bias"))
        convbn(f"{d}.attn.q.proj", (f, "q"))
        for name in ("k", "v", "v_local", "proj"):
            convbn(f"{d}.attn.{name}", (f, name))
        m(f"{d}.attn.attention_biases", (f, "attention_biases"))
    blocks = sorted((int(a), int(b)) for t in tops
                    for a, b in re.findall(r"^stages_(\d+)_block(\d+)_ffn$", t))
    for s, b in blocks:
        t, f = f"stages.{s}.blocks.{b}", f"stages_{s}_block{b}"
        for name in ("fc1", "mid", "fc2"):
            convbn(f"{t}.mlp.{name}", (f"{f}_ffn", name))
        m(f"{t}.ls2.gamma", (f"{f}_ffn_res", "gamma"))
        if f"{f}_attn" in tops:
            tm, fa = f"{t}.token_mixer", (f"{f}_attn",)
            for name in ("stride_conv", "q", "k", "v", "v_local", "proj"):
                convbn(f"{tm}.{name}", fa + (name,))
            for th in ("talking_head1", "talking_head2"):
                m(f"{tm}.{th}.weight", fa + (th,), "talking_head")
                m(f"{tm}.{th}.bias", fa + (f"{th}_bias",))
            m(f"{tm}.attention_biases", fa + ("attention_biases",))
            m(f"{t}.ls1.gamma", (f"{f}_attn_res", "gamma"))
    m.bn("norm", ("norm_out",))
    m.dense("head", ("head",))
    m.dense("head_dist", ("head_dist",))
    return m.m


_MAPS = {"efficientnet": _efficientnet_map, "efficientformerv2": _efficientformer_v2_map,
         "fastervit": _fastervit_map}


def _name_map(family: str, flat: dict[Path_, Any]) -> NameMap:
    """The family's name map for a flattened tree: its top-level modules,
    and for FasterViT the stage-2 blocks that are ``PlainBlock``s."""
    tops = {p[1] for p in flat}
    if family != "fastervit":
        return _MAPS[family](tops)
    plain = frozenset(p[1] for p in flat if len(p) > 2 and p[1].startswith("stage2_block")
                      and p[2] == "blk")
    return _fastervit_map(tops, plain)


def state_dict_from_jax(tree: dict[str, Any], family: str) -> dict[str, torch.Tensor]:
    """JAX package variables ``{"params", "batch_stats"}`` (numpy leaves, or
    ``flax_msgpack``'s tensors) ->
    the port's state dict of ``family`` ("efficientnet", "efficientformerv2"
    or "fastervit"):
    every tensor of the tree whose path the family's map names, in the
    torch layout. Raises when the tree holds a tensor the map leaves out."""
    flat = _flatten(tree)
    name_map = _name_map(family, flat)
    sd, used = {}, set()
    for key, (path, kind) in name_map.items():
        full = (("batch_stats",) if path[-1] in ("mean", "var") else ("params",)) + path
        if full in flat:
            leaf = flat[full]
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.float().numpy()
            arr = _inverse_layout(np.asarray(leaf, np.float32), kind)
            sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
            used.add(full)
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{family}: no port name for {['/'.join(p) for p in left[:8]]}")
    return sd


def conv_names_from_jax(tree: dict[str, Any], family: str) -> dict[str, str]:
    """The flax module path of every conv kernel of ``tree`` ("/"-joined, as
    the JAX package keys its int8 activation scales) -> the port's name for
    that conv (its module name, which keys a ConvBN's scale in
    ``ops/quant.py``), through the family's name map."""
    flat = _flatten(tree)
    names = {}
    for key, (path, _) in _name_map(family, flat).items():
        if key.endswith(".weight") and path[-1] == "kernel":
            names["/".join(path[:-1])] = key[: -len(".weight")]
    return names


def load_state_dict_strict(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """``load_state_dict(strict=True)``, except that BatchNorm's
    ``num_batches_tracked`` counters may be absent."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")


# the tensors only FasterViT's "tpu" head configuration has (a suffix of the
# key): learned bias tables, layer scales, the learned position tables
_FASTERVIT_TPU_KEYS = (".attn.rel_bias", ".gamma", "gamma1", "gamma2", "levels.2.ct_pos_embed",
                       "levels.2.win_pos_embed", "levels.3.pos_embed_table")


def fastervit_head_config(state: dict[str, torch.Tensor]) -> str:
    """The FasterViT head configuration a torch state dict was made in:
    "tpu" when it carries that configuration's own tensors (the port's and
    the converter's exports of a tpu model), "official" for any other (the
    fastervit wheel's checkpoints). The JAX package reads a torch file as
    official whatever it holds, which is right for the wheel's files it
    meets; reading the tensors also gives the port's own exports back their
    configuration."""
    return "tpu" if any(k.endswith(_FASTERVIT_TPU_KEYS) for k in state) else "official"


def is_torch_checkpoint(path: Path) -> bool:
    """True for a PyTorch checkpoint (zip or legacy pickle)."""
    with Path(path).open("rb") as f:
        magic = f.read(2)
    return magic[:2] == b"PK" or magic[:1] == b"\x80"


def load_weights(path: str | Path, family: str | None = None) -> dict[str, torch.Tensor]:
    """A torch ``.pth`` state dict, unwrapped from ``{"state_dict": ...}`` or
    ``{"model": ...}``; or a native flax msgpack export (whatever its name)
    read without JAX and carried into ``family``'s names by
    ``state_dict_from_jax``, which the model family must then be given for."""
    path = Path(path)
    if not is_torch_checkpoint(path):
        if family is None:
            raise ValueError(
                f"{path} is not a torch checkpoint (a native flax msgpack export?); reading "
                "one needs the model family (load_weights(path, family))"
            )
        return state_dict_from_jax(flax_msgpack.read(path), family)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for wrapper in _WRAPPERS:
            if isinstance(obj.get(wrapper), dict):
                obj = obj[wrapper]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds no state dict")
    return obj
