"""Arch registry: uniform adapter over the model families, the
counterpart of ``repro.models.registry``.

    adapter = get_adapter("rwkv6-3b")
    params  = adapter.init(torch.Generator("cuda").manual_seed(0), tp=1)
    specs   = adapter.param_specs(fsdp="data", tp=1)     # spec tuples
    logits  = adapter.forward(params, batch)          # train / prefill
    loss    = adapter.loss(params, batch, remat=True) # differentiable
    state   = adapter.init_decode_state(batch, max_seq, device="cuda")
    logits, state = adapter.decode(params, {"tokens": tokens}, state, pos)

``batch`` is a dict: {"tokens": (b, s)} plus the family's
``extra_inputs`` ("vision_embeds" (b, n_vision_tokens, d_model) for vlm,
"frames" (b, n_audio_frames, d_model) for audio) and "labels" for
``loss``. ``pos`` is a host int. The dense and MoE families share
``models/transformer``, as in the reference; the SSM family runs
``models/rwkv6``, whose decode state ignores ``max_seq`` and ``dtype`` (as
the reference's does: the state's dtypes are fixed); the hybrid family
runs ``models/zamba2``, whose decode state holds fp32 SSM states, conv
tails and a KV cache in ``dtype`` for each application of its shared
attention block; the vlm family runs ``models/mllama`` and the audio
family ``models/whisper``, whose decode states add a cross KV (zeros until
the caller fills it from ``precompute_cross_kv``). ``remat``
recomputes each layer (block) in the backward, as the reference's
``jax.checkpoint`` does; ``launch/train.py`` trains through ``loss``.
``init`` pads the query heads to a multiple of ``tp``;
``param_specs`` and ``state_specs`` are the reference's named-axis spec
tuples of the parameters and the decode state
(``distributed/sharding.py`` places them on a mesh). ``init_decode_state``
and ``decode`` take a ``mesh`` (default none: the meshless step): each
rank decodes its rows of the batch, and every family also decodes on a
``model`` axis of several ranks: the dense and MoE families tensor- and
context-parallel, the MoE's experts split by ``moe_param_specs``
(``models/transformer.py``, ``models/moe.py``), rwkv6 on its heads
(``models/rwkv6.py``), zamba2 on its SSM heads with its packed in_proj
and conv laid out by a rank's parts (``place_decode_params``,
``models/zamba2.py``), and the VLM and audio families tensor- and
context-parallel with their cross KV split by sequence where the axis
divides it and whole elsewhere (``models/mllama.py``,
``models/whisper.py``). ``forward`` and
``loss`` take a ``mesh`` too (default none): where the ``model`` axis
holds several ranks, the dense, MoE, SSM and hybrid families compute on
each rank's shards of the parameters (the training forward on shards);
:func:`train_tp_path` says which families and shapes do, and the train
step gathers the others' parameters whole. On a mesh whose ``model`` axis
holds one rank the forward is the single-process one, except that the
MoE family forms its routing groups over the rows of the mesh's batch
axes (the reference's groups over the whole batch). The reference's
``input_structs`` and ``supports`` wait for the launch-tooling slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..configs.registry_configs import ALL_ARCHS
from ..distributed.sharding import (constrain_like, data_rows,
                                    local_tree, model_size)
from . import mllama, rwkv6, transformer, whisper, zamba2


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; logits (b, s, Vp), labels
    (b, s). Padded vocab entries never win: they are set to -1e9 before
    the logsumexp."""
    lg = logits[:, :-1].float()
    lb = labels[:, 1:].long()
    Vp = lg.shape[-1]
    if Vp > vocab:
        pad = torch.arange(Vp, device=lg.device) >= vocab
        lg = torch.where(pad, -1e9, lg)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, lb[..., None])[..., 0]
    return torch.mean(lse - picked)


def _tfm_forward(params, cfg, batch, remat, mesh=None):
    return transformer.forward(params, cfg, batch["tokens"], remat, mesh)


def _tfm_decode(params, cfg, batch, state, pos, mesh=None):
    return transformer.decode_step(params, cfg, batch["tokens"], state, pos,
                                   mesh)


# The families that decode on a model axis of several ranks: all of them.
TP_DECODE_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_decode_mesh(cfg, model: int) -> None:
    """Raise where `cfg`'s family has no tensor-parallel decode and the
    mesh's ``model`` axis holds `model` > 1 ranks; every family has one
    now (:data:`TP_DECODE_FAMILIES`). A shape that does not split is
    refused by the family's decode state, placement or step, with the
    reason (reduced rwkv6-3b's one head, zamba2's SSM heads)."""
    if model > 1 and cfg.family not in TP_DECODE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family decodes on a model axis "
            f"of one rank only")


def _rwkv_forward(params, cfg, batch, remat, mesh=None):
    return rwkv6.forward(params, cfg, batch["tokens"], remat, mesh)


def train_tp_path(cfg, model: int) -> tuple[bool, str]:
    """(whether `cfg` computes on the shards of a ``model`` axis of
    `model` ranks, a sentence that says so): the dense and MoE families,
    rwkv6 and zamba2 where the axis divides their shapes
    (``transformer.train_tp_refusal``, ``rwkv6.train_tp_refusal``,
    ``zamba2.train_tp_refusal``). Every
    other case trains with each parameter gathered whole on every rank;
    on a ``model`` axis of one rank that is the single-process step."""
    if model <= 1:
        return False, (f"{cfg.name}: a model axis of one rank; each rank "
                       f"computes the whole model")
    if cfg.family in ("dense", "moe"):
        refusal = transformer.train_tp_refusal(cfg, model)
    elif cfg.family == "ssm":
        refusal = rwkv6.train_tp_refusal(cfg, model)
    elif cfg.family == "hybrid":
        refusal = zamba2.train_tp_refusal(cfg, model)
    else:
        refusal = (f"{cfg.name}: the {cfg.family} family does not compute "
                   f"on model shards in training yet (ROADMAP Queue 1)")
    if refusal is not None:
        return False, (f"{refusal}; each rank gathers every parameter "
                       f"whole and computes the whole model")
    return True, (f"{cfg.name}: each rank computes on its shards of a "
                  f"model axis of {model} ranks")


def _rwkv_decode(params, cfg, batch, state, pos, mesh=None):
    return rwkv6.decode_step(params, cfg, batch["tokens"], state, pos, mesh)


def _rwkv_init_state(cfg, batch, max_seq, dtype, device, tp=1, mesh=None):
    return rwkv6.init_state(cfg, batch, device, mesh)


def _zamba_forward(params, cfg, batch, remat, mesh=None):
    return zamba2.forward(params, cfg, batch["tokens"], remat, mesh)


def _zamba_decode(params, cfg, batch, state, pos, mesh=None):
    return zamba2.decode_step(params, cfg, batch["tokens"], state, pos,
                              mesh)


def _mllama_forward(params, cfg, batch, remat):
    return mllama.forward(params, cfg, batch["tokens"],
                          batch["vision_embeds"], remat)


def _mllama_decode(params, cfg, batch, state, pos, mesh=None):
    return mllama.decode_step(params, cfg, batch["tokens"], state, pos,
                              mesh)


def _whisper_forward(params, cfg, batch, remat):
    return whisper.forward(params, cfg, batch["tokens"], batch["frames"],
                           remat)


def _whisper_decode(params, cfg, batch, state, pos, mesh=None):
    return whisper.decode_step(params, cfg, batch["tokens"], state, pos,
                               mesh)


_TRANSFORMER = dict(init=transformer.init, forward=_tfm_forward,
                    decode=_tfm_decode, init_state=transformer.init_cache,
                    param_specs=transformer.param_specs,
                    state_specs=transformer.cache_specs)

_FAMILY = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "ssm": dict(init=rwkv6.init, forward=_rwkv_forward, decode=_rwkv_decode,
                init_state=_rwkv_init_state, param_specs=rwkv6.param_specs,
                state_specs=rwkv6.state_specs),
    "hybrid": dict(init=zamba2.init, forward=_zamba_forward,
                   decode=_zamba_decode, init_state=zamba2.init_state,
                   param_specs=zamba2.param_specs,
                   state_specs=zamba2.state_specs,
                   place_decode=zamba2.place_decode_params),
    "vlm": dict(init=mllama.init, forward=_mllama_forward,
                decode=_mllama_decode, init_state=mllama.init_cache,
                param_specs=mllama.param_specs,
                state_specs=mllama.cache_specs,
                extra_inputs=("vision_embeds",)),
    "audio": dict(init=whisper.init, forward=_whisper_forward,
                  decode=_whisper_decode, init_state=whisper.init_cache,
                  param_specs=whisper.param_specs,
                  state_specs=whisper.cache_specs,
                  extra_inputs=("frames",)),
}


@dataclass
class ModelAdapter:
    cfg: ArchConfig

    @property
    def _fns(self) -> dict:
        return _FAMILY[self.cfg.family]

    @property
    def extra_inputs(self) -> tuple:
        """Inputs beside "tokens" that ``forward`` reads."""
        return self._fns.get("extra_inputs", ())

    def init(self, gen: torch.Generator, tp: int = 1) -> dict:
        return self._fns["init"](self.cfg, gen, tp)

    def param_specs(self, fsdp=None, tp: int = 16) -> dict:
        """Spec tuples mirroring ``init``'s tree; `fsdp` names the mesh
        axis of ZeRO-3 parameter sharding (None: replicated over data)."""
        return self._fns["param_specs"](self.cfg, fsdp, tp)

    def forward(self, params: dict, batch: dict, remat: bool = False,
                mesh=None) -> torch.Tensor:
        """Logits (b, s, V_padded) of a whole sequence (train / prefill);
        with `remat` each layer is recomputed in the backward. With a
        `mesh` whose ``model`` axis holds several ranks, `params` are this
        rank's shards and the logits are whole on every rank, for the
        families and shapes :func:`train_tp_path` names; the others raise
        there.
        Without a mesh, or on a ``model`` axis of one rank, the
        single-process forward on whole parameters (the MoE family's
        routing groups formed over the rows of the mesh's batch axes,
        whose ranks then hold this rank's coordinates)."""
        if mesh is None or model_size(mesh) == 1:
            if self.cfg.moe and data_rows(mesh)[1] > 1:
                return self._fns["forward"](params, self.cfg, batch, remat,
                                            mesh)
            return self._fns["forward"](params, self.cfg, batch, remat)
        ok, why = train_tp_path(self.cfg, model_size(mesh))
        if not ok:
            raise NotImplementedError(why)
        return self._fns["forward"](params, self.cfg, batch, remat, mesh)

    def supports_train_tp(self, model: int) -> bool:
        """Whether this family and shape compute on model shards in
        training on a ``model`` axis of `model` ranks
        (:func:`train_tp_path`)."""
        return train_tp_path(self.cfg, model)[0]

    def loss(self, params: dict, batch: dict, remat: bool = False,
             mesh=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``forward``'s logits against
        batch["labels"], padded vocab entries masked."""
        return _xent(self.forward(params, batch, remat, mesh),
                     batch["labels"], self.cfg.vocab)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype=torch.bfloat16, device="cuda",
                          tp: int = 1, mesh=None) -> dict:
        """The decode state of `batch` rows; on a `mesh` this rank's share:
        its rows, and on a ``model`` axis of several ranks its shard of the
        KV cache (the dense, MoE, VLM and audio families; the cross KV of
        the last two too, where the axis divides it), its heads of
        rwkv6's state, or zamba2's by its parts (each family's
        ``init_cache`` or ``init_state``)."""
        if mesh is None:
            return self._fns["init_state"](self.cfg, batch, max_seq, dtype,
                                           device, tp)
        check_decode_mesh(self.cfg, model_size(mesh))
        return self._fns["init_state"](self.cfg, batch, max_seq, dtype,
                                       device, tp, mesh)

    def decode(self, params: dict, batch: dict, state: dict, pos: int,
               mesh=None):
        """One decode step; on a `mesh`, of this rank's rows, `params`
        this rank's shards (see ``transformer.decode_step``)."""
        if mesh is None:
            return self._fns["decode"](params, self.cfg, batch, state, pos)
        check_decode_mesh(self.cfg, model_size(mesh))
        return self._fns["decode"](params, self.cfg, batch, state, pos,
                                   mesh)

    def place_decode_params(self, params: dict, mesh, tp: int) -> dict:
        """This rank's decode parameters from `params` (the same on every
        rank): its shards under ``param_specs(None, tp)``, replicated over
        ``data`` (plain tensors, the parameters themselves where nothing is
        split); zamba2 on a ``model`` axis of several ranks lays in_proj,
        conv_w and its per-head leaves out by a rank's parts instead
        (``zamba2.place_decode_params``)."""
        place = self._fns.get("place_decode")
        if place is not None:
            return place(params, self.cfg, mesh, tp)
        return local_tree(constrain_like(params, self.param_specs(None, tp),
                                         mesh))

    def state_specs(self) -> dict:
        """Spec tuples of the decode state's tree."""
        return self._fns["state_specs"](self.cfg)


def get_adapter(arch_id_or_cfg) -> ModelAdapter:
    cfg = (arch_id_or_cfg if isinstance(arch_id_or_cfg, ArchConfig)
           else ALL_ARCHS[arch_id_or_cfg])
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet")
    return ModelAdapter(cfg)
