"""DFINETransformer decoder (PyTorch): eval and train paths.

Counterpart of custom_d_fine_tpu/models/decoder.py; parity target reference
src/d_fine/arch/dfine_decoder.py: MSDeformableAttention (:49-178),
TransformerDecoderLayer (:181-255), Gate (:258-271), Integral (:274-295),
LQE (:298-313), TransformerDecoder FDR loop (:373-524), DFINETransformer
(:527-1057), MaskDecoder (:316-370) and the mask head (:925-1005). In train
mode it adds the CDN denoising queries and returns the aux, pre, enc and dn
output sets the criterion reads, with .detach() exactly where the JAX
package has stop_gradient. Under torch.profiler the mask head records the
span `model.mask_head`, in eval too (utils/profiling.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import inverse_sigmoid
from ..ops.deform_attn import ms_deform_attn_discrete
from ..ops.fdr import distance2bbox, weighting_function
from ..ops.msda import msda
from ..utils.profiling import span
from .denoising import build_cdn_group, build_dn_attn_mask, dn_layout
from .layers import LN_EPS, MLP, BatchNorm, MultiHeadAttention, get_activation

GN_EPS = 1e-6  # flax nn.GroupNorm's default, which the JAX package uses (torch's is 1e-5)


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention (reference dfine_decoder.py:49-178).
    method "default" samples bilinearly through ops/msda.py:msda, whose
    forward and backward are the MSDA kernels; "discrete" takes the nearest
    pixel (ops/deform_attn.py:ms_deform_attn_discrete, plain PyTorch on
    every device, as the JAX package's XLA path) and never runs the MSDA
    kernels."""

    def __init__(self, embed_dim: int, num_heads: int, num_levels: int,
                 num_points: Sequence[int], offset_scale: float = 0.5,
                 method: str = "default"):
        super().__init__()
        if method not in ("default", "discrete"):
            raise ValueError(f"cross_attn_method={method!r}: expected 'default' or 'discrete'")
        self.method = method
        self.num_heads = num_heads
        self.num_points = tuple(num_points)
        self.offset_scale = offset_scale
        P = sum(self.num_points)
        self.sampling_offsets = nn.Linear(embed_dim, P * 2 * num_heads)
        self.attention_weights = nn.Linear(embed_dim, P * num_heads)
        nps = np.concatenate([np.full((n,), 1.0 / n, np.float32) for n in self.num_points])
        self.register_buffer("num_points_scale", torch.from_numpy(nps), persistent=False)

    def locations(self, query: torch.Tensor, reference_points: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sampling locations loc [B, Lq, h, P, 2] (x, y) and the softmaxed
        attention weights [B, Lq, h, P] of `query` around its reference box."""
        B, Lq, _ = query.shape
        h, P = self.num_heads, sum(self.num_points)
        offsets = self.sampling_offsets(query).reshape(B, Lq, h, P, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(B, Lq, h, P), dim=-1)
        # reference 4-dim branch (:156-166): offset scaled by box wh and 1/n per level
        offset = (offsets * self.num_points_scale[None, None, None, :, None]
                  * reference_points[:, :, None, None, 2:] * self.offset_scale)
        return reference_points[:, :, None, None, :2] + offset, attn

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        loc, attn = self.locations(query, reference_points)
        if self.method == "discrete":
            return ms_deform_attn_discrete(value, spatial_shapes, loc, attn, self.num_points)
        return msda(value, spatial_shapes, loc, attn, self.num_points)


class Gate(nn.Module):
    """Gated fusion of the self-attn and cross-attn streams
    (reference dfine_decoder.py:258-271)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.gate = nn.Linear(2 * d_model, 2 * d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        gates = torch.sigmoid(self.gate(torch.cat([x1, x2], dim=-1)))
        g1, g2 = gates[..., :self.d_model], gates[..., self.d_model:]
        return self.norm(g1 * x1 + g2 * x2)


class TransformerDecoderLayer(nn.Module):
    """self-attn -> deformable cross-attn -> gate -> FFN
    (reference dfine_decoder.py:181-255)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 activation: str = "relu", num_levels: int = 3,
                 num_points: Sequence[int] = (3, 6, 3), cross_attn_method: str = "default"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformableAttention(d_model, n_head, num_levels, num_points,
                                                method=cross_attn_method)
        self.gateway = Gate(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.activation = get_activation(activation)

    def forward(self, target, reference_points, value, spatial_shapes,
                attn_mask=None, query_pos_embed=None):
        q = k = target if query_pos_embed is None else target + query_pos_embed
        target = self.norm1(target + self.self_attn(q, k, target, attn_mask=attn_mask))
        t2 = self.cross_attn(target if query_pos_embed is None else target + query_pos_embed,
                             reference_points, value, spatial_shapes)
        target = self.gateway(target, t2)
        ff = self.linear2(self.activation(self.linear1(target)))
        return self.norm3((target + ff).clamp(-65504.0, 65504.0))


def integral(x: torch.Tensor, project: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Softmax over bins, expectation under W(n) (reference dfine_decoder.py:274-295).
    x [..., 4*(reg_max+1)] -> [..., 4]."""
    p = torch.softmax(x.reshape(*x.shape[:-1], 4, reg_max + 1), dim=-1)
    return (p * project.to(p.dtype)).sum(-1)


class LQE(nn.Module):
    """Location-quality estimator: top-k distribution stats -> score delta
    (reference dfine_decoder.py:298-313)."""

    def __init__(self, k: int, hidden_dim: int, num_layers: int, reg_max: int):
        super().__init__()
        self.k, self.reg_max = k, reg_max
        self.reg_conf = MLP(4 * (k + 1), hidden_dim, 1, num_layers)

    def forward(self, scores: torch.Tensor, pred_corners: torch.Tensor) -> torch.Tensor:
        B, L, _ = pred_corners.shape
        prob = torch.softmax(pred_corners.reshape(B, L, 4, self.reg_max + 1), dim=-1)
        prob_topk = prob.topk(self.k, dim=-1).values
        stat = torch.cat([prob_topk, prob_topk.mean(dim=-1, keepdim=True)], dim=-1)
        return scores + self.reg_conf(stat.reshape(B, L, -1))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") for an upsampling NCHW resize: half-pixel
    centres, and at the borders the weights of the missing neighbours dropped
    and the rest renormalised, which is align_corners=False's clamp of the
    source coordinate. (JAX antialiases only when it downsamples, and the
    mask head only upsamples.)"""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class MaskDecoder(nn.Module):
    """Fuse the PAN levels into H/4 mask features (reference
    dfine_decoder.py:316-370; JAX models/decoder.py:182-207): per level a 1x1
    lateral conv and GroupNorm(32), the coarser levels resized to the finest
    and summed, a 3x3 fusion conv with GroupNorm and ReLU, a 2x upsample and
    a 3x3 up_conv with GroupNorm (`bn1`) and ReLU. NCHW in, [B, out_ch, 2H0,
    2W0] out, where H0 x W0 is the finest level."""

    def __init__(self, in_channels: Sequence[int], out_ch: int = 256, n_groups: int = 32):
        super().__init__()
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_ch, 1, bias=False) for c in in_channels)
        self.bn = nn.ModuleList(nn.GroupNorm(n_groups, out_ch, eps=GN_EPS) for _ in in_channels)
        self.fusion_conv = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.fusion_norm = nn.GroupNorm(n_groups, out_ch, eps=GN_EPS)
        self.up_conv = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = nn.GroupNorm(n_groups, out_ch, eps=GN_EPS)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        base = None
        for lateral, norm, f in zip(self.lateral, self.bn, feats):
            t = norm(lateral(f))
            base = t if base is None else base + resize_bilinear(t, tuple(base.shape[-2:]))
        x = F.relu(self.fusion_norm(self.fusion_conv(base)))
        x = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))
        return F.relu(self.bn1(self.up_conv(x)))


def generate_anchors(spatial_shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05,
                     eps: float = 1e-2) -> Tuple[np.ndarray, np.ndarray]:
    """Log-space anchor priors per level (reference dfine_decoder.py:803-826);
    inf where an anchor is invalid. Returns ([1, L, 4], [1, L, 1] bool)."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                             indexing="ij")
        gxy = (np.stack([gx, gy], -1) + 0.5) / np.array([w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** lvl)
        anchors.append(np.concatenate([gxy, wh], -1).reshape(h * w, 4))
    a = np.concatenate(anchors, 0)[None]
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
    a = np.log(a / (1 - a))
    return np.where(valid, a, np.inf).astype(np.float32), valid


class TransformerDecoder(nn.Module):
    """Holds the decoder layers and their LQE heads, under the reference's
    state_dict names (decoder.decoder.layers.*, decoder.decoder.lqe_layers.*)."""

    def __init__(self, layers: List[nn.Module], lqe_layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.lqe_layers = nn.ModuleList(lqe_layers)


class DFINETransformer(nn.Module):
    def __init__(self, num_classes: int = 80, hidden_dim: int = 256, num_queries: int = 300,
                 feat_channels: Sequence[int] = (256, 256, 256),
                 feat_strides: Sequence[int] = (8, 16, 32), num_levels: int = 3,
                 num_points: Sequence[int] = (3, 6, 3), nhead: int = 8, num_layers: int = 6,
                 dim_feedforward: int = 1024, activation: str = "relu",
                 num_denoising: int = 100, dn_max_gt: int = 50,
                 label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0,
                 eval_idx: int = -1, eps: float = 1e-2, reg_max: int = 32,
                 reg_scale: float = 4.0, cross_attn_method: str = "default",
                 query_select_method: str = "default", enable_mask_head: bool = False,
                 mask_dim: int = 256):
        super().__init__()
        if query_select_method not in ("default", "agnostic", "one2many"):
            raise ValueError(f"query_select_method={query_select_method!r}: expected "
                             f"'default', 'agnostic' or 'one2many'")
        C = hidden_dim
        self.cross_attn_method, self.query_select_method = cross_attn_method, query_select_method
        self.num_classes, self.hidden_dim, self.num_queries = num_classes, C, num_queries
        self.num_levels, self.nhead, self.num_layers = num_levels, nhead, num_layers
        self.eval_idx = eval_idx if eval_idx >= 0 else num_layers + eval_idx
        self.eps, self.reg_max, self.reg_scale = eps, reg_max, reg_scale
        self.num_denoising, self.dn_max_gt = num_denoising, dn_max_gt
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale

        self.input_proj = nn.ModuleList()
        for ch in feat_channels:
            self.input_proj.append(nn.Identity() if ch == C else nn.Sequential(OrderedDict([
                ("conv", nn.Conv2d(ch, C, 1, bias=False)), ("norm", BatchNorm(C))])))
        in_ch = feat_channels[-1]
        for _ in range(len(feat_channels), num_levels):
            self.input_proj.append(nn.Sequential(OrderedDict([
                ("conv", nn.Conv2d(in_ch, C, 3, 2, padding=1, bias=False)),
                ("norm", BatchNorm(C))])))
            in_ch = C

        self.decoder = TransformerDecoder(
            [TransformerDecoderLayer(C, nhead, dim_feedforward, activation, num_levels,
                                     num_points, cross_attn_method) for _ in range(num_layers)],
            [LQE(4, 64, 2, reg_max) for _ in range(num_layers)])
        if num_denoising > 0:
            self.denoising_class_embed = nn.Embedding(num_classes + 1, C,
                                                      padding_idx=num_classes)
        self.query_pos_head = MLP(4, 2 * C, C, 2)
        self.enc_output = nn.Sequential(OrderedDict([
            ("proj", nn.Linear(C, C)), ("norm", nn.LayerNorm(C, eps=LN_EPS))]))
        self.enc_score_head = nn.Linear(C, 1 if query_select_method == "agnostic" else num_classes)
        self.enc_bbox_head = MLP(C, C, 4, 3)
        self.pre_bbox_head = MLP(C, C, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(C, num_classes) for _ in range(num_layers))
        self.dec_bbox_head = nn.ModuleList(
            MLP(C, C, 4 * (reg_max + 1), 3) for _ in range(num_layers))
        self.enable_mask_head, self.mask_dim = enable_mask_head, mask_dim
        if enable_mask_head:
            self.mask_decoder = MaskDecoder(feat_channels, mask_dim)
            self.mask_head = MLP(C, C, mask_dim, 3)
        self.register_buffer("project", weighting_function(reg_max, 0.5, reg_scale),
                             persistent=False)
        self._const_cache: Dict = {}

    def _const(self, key, make, device):
        """Static numpy constants (anchors, the DN attention mask) on `device`."""
        key = (key, device)
        if key not in self._const_cache:
            self._const_cache[key] = tuple(torch.from_numpy(a).to(device) for a in make())
        return self._const_cache[key]

    def forward(self, feats: Sequence[torch.Tensor],
                msda_value_dtype: Optional[torch.dtype] = None,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, object]:
        """NCHW PAN outputs -> {"pred_logits" [B,Q,C], "pred_boxes" [B,Q,4] cxcywh,
        with the mask head "pred_masks" [B,Q,Hm,Wm] (probabilities in eval
        mode, logits in train mode; Hm x Wm is twice the finest level)} and,
        in train mode, the criterion's output sets. msda_value_dtype: dtype
        of the MSDA kernel's value map (None keeps the memory's dtype; the
        card's serving and bf16 training pass bf16, as the TPU's
        pallas_sep_fast does). The discrete cross-attention ignores it and
        gathers from the memory in the model's compute dtype, as the JAX
        package's XLA path, the only one that computes it, does.
        targets {labels [B,G], boxes [B,G,4], valid [B,G]} and dn_draws
        (models/denoising.draw_dn_noise) switch on the denoising queries in
        train mode."""
        C = self.hidden_dim
        train = self.training
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        for i in range(len(feats), self.num_levels):
            proj.append(self.input_proj[i](feats[-1] if i == len(feats) else proj[-1]))
        B = proj[0].shape[0]
        spatial_shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in proj)
        memory = torch.cat([f.permute(0, 2, 3, 1).reshape(B, -1, C) for f in proj], dim=1)
        dev = memory.device

        # ---- denoising group (train only; static layout)
        use_dn = train and self.num_denoising > 0 and targets is not None
        num_dn, attn_mask = 0, None
        if use_dn:
            if dn_draws is None:
                raise ValueError("train mode with targets needs dn_draws "
                                 "(models/denoising.draw_dn_noise)")
            num_group, num_dn, _ = dn_layout(self.num_denoising, self.dn_max_gt,
                                             self.num_queries)
            dn = build_cdn_group(targets["labels"], targets["boxes"], targets["valid"],
                                 dn_draws, num_classes=self.num_classes, num_group=num_group,
                                 dn_max_gt=self.dn_max_gt,
                                 label_noise_ratio=self.label_noise_ratio,
                                 box_noise_scale=self.box_noise_scale)
            dn_content = self.denoising_class_embed(dn["labels"]) * dn["valid"][..., None]
            attn_mask, = self._const(("dn_mask", num_group), lambda: (build_dn_attn_mask(
                num_group, self.dn_max_gt, self.num_queries),), dev)

        # ---- anchors + encoder-token query selection (reference :803-910)
        anchors, valid = self._const(("anchors", spatial_shapes),
                                     lambda: generate_anchors(spatial_shapes, eps=self.eps), dev)
        out_mem = self.enc_output(valid.to(memory.dtype) * memory)
        enc_logits = self.enc_score_head(out_mem)
        if self.query_select_method == "one2many":
            # top-K over (anchor, class) pairs: an anchor may be chosen once per class
            flat_ind = enc_logits.flatten(1).topk(self.num_queries, dim=1).indices
            topk_ind = flat_ind // self.num_classes
        else:  # "agnostic" has one column
            topk_ind = enc_logits.max(-1).values.topk(self.num_queries, dim=1).indices

        def gather_q(x):
            return torch.gather(x, 1, topk_ind[..., None].expand(-1, -1, x.shape[-1]))

        content = gather_q(out_mem)
        ref_unact = self.enc_bbox_head(content) + gather_q(anchors.expand(B, -1, -1))
        if train:
            enc_aux = [{"pred_logits": gather_q(enc_logits),
                        "pred_boxes": torch.sigmoid(ref_unact)}]
            content, ref_unact = content.detach(), ref_unact.detach()
        if use_dn:
            ref_unact = torch.cat([dn["bbox_unact"].to(ref_unact.dtype), ref_unact], dim=1)
            content = torch.cat([dn_content.to(content.dtype), content], dim=1)

        # ---- FDR decoder loop (reference TransformerDecoder.forward :429-524)
        value = memory.reshape(B, memory.shape[1], self.nhead, C // self.nhead)
        if msda_value_dtype is not None and self.cross_attn_method != "discrete":
            value = value.to(msda_value_dtype)
        value = value.contiguous()
        output = content
        ref_points = torch.sigmoid(ref_unact)
        output_detach = torch.zeros_like(output)
        pred_corners_prev = 0.0
        ref_points_initial = pre_logits = pre_bboxes = None
        logits_l, bboxes_l, corners_l, refs_l, queries_l = [], [], [], [], []
        for i in range(self.num_layers if train else self.eval_idx + 1):
            query_pos = self.query_pos_head(ref_points).clamp(-10.0, 10.0)
            output = self.decoder.layers[i](output, ref_points, value, spatial_shapes,
                                            attn_mask=attn_mask, query_pos_embed=query_pos)
            if self.enable_mask_head and (train or i == self.eval_idx):
                queries_l.append(output)
            if i == 0:
                pre_delta = self.pre_bbox_head(output)
                pre_bboxes = torch.sigmoid(pre_delta + inverse_sigmoid(ref_points))
                pre_logits = self.dec_score_head[0](output)
                ref_points_initial = pre_bboxes.detach()
            # pred_corners stays attached to the previous layers' corners, as in JAX
            pred_corners = self.dec_bbox_head[i](output + output_detach) + pred_corners_prev
            inter_ref_bbox = distance2bbox(
                ref_points_initial, integral(pred_corners, self.project, self.reg_max),
                self.reg_scale)
            if train or i == self.eval_idx:
                scores = pre_logits if i == 0 else self.dec_score_head[i](output)
                logits_l.append(self.decoder.lqe_layers[i](scores, pred_corners))
                bboxes_l.append(inter_ref_bbox)
                corners_l.append(pred_corners)
                refs_l.append(ref_points_initial)
            pred_corners_prev = pred_corners
            ref_points = inter_ref_bbox.detach()
            output_detach = output.detach()

        # ---- split the denoising slots off (reference :975-986)
        def split(x):
            return x[:, :num_dn], x[:, num_dn:]

        # ---- mask head (reference :925-1005): per kept layer, its queries'
        # embeddings against the mask features; span `model.mask_head` counts
        # the mask pixels B x Hm x Wm, the query rows projected (dn included)
        # and the layers
        masks_l = dn_masks_l = None
        if self.enable_mask_head:
            with span("model.mask_head", layers=len(queries_l),
                      rows=sum(h.shape[0] * h.shape[1] for h in queries_l)) as sp:
                mask_feat = self.mask_decoder(feats)  # [B, mask_dim, Hm, Wm]
                Hm, Wm = mask_feat.shape[2:]
                sp.count(pixels=B * Hm * Wm)
                masks_l = [torch.matmul(self.mask_head(h) * self.mask_dim ** -0.5,
                                        mask_feat.flatten(2)).reshape(B, -1, Hm, Wm)
                           for h in queries_l]
                dn_masks_l, masks_l = tuple(zip(*[split(m) for m in masks_l]))

        if not train:
            out = {"pred_logits": logits_l[-1], "pred_boxes": bboxes_l[-1]}
            if masks_l is not None:
                out["pred_masks"] = torch.sigmoid(masks_l[-1])
            return out

        (dn_logits, logits), (dn_bboxes, bboxes), (dn_corners, corners), (dn_refs, refs) = (
            tuple(zip(*[split(t) for t in ts])) for ts in (logits_l, bboxes_l, corners_l, refs_l))
        dn_pre_logits, pre_logits = split(pre_logits)
        dn_pre_bboxes, pre_bboxes = split(pre_bboxes)

        def sets(lg, bx, cr, rf, ms):
            out = [{"pred_logits": l, "pred_boxes": b, "pred_corners": c, "ref_points": r,
                    "teacher_corners": cr[-1], "teacher_logits": lg[-1]}
                   for l, b, c, r in zip(lg, bx, cr, rf)]
            for o, m in zip(out, ms or ()):
                o["pred_masks"] = m
            return out

        out = {"pred_logits": logits[-1], "pred_boxes": bboxes[-1],
               "pred_corners": corners[-1], "ref_points": refs[-1],
               "up": 0.5, "reg_scale": self.reg_scale,
               "aux_outputs": sets(logits, bboxes, corners, refs, masks_l)[:-1],
               "pre_outputs": {"pred_logits": pre_logits, "pred_boxes": pre_bboxes},
               "enc_aux_outputs": enc_aux,
               "enc_meta": {"class_agnostic": self.query_select_method == "agnostic"}}
        if masks_l is not None:
            out["pred_masks"] = masks_l[-1]
        if use_dn:
            # the dn sets carry masks on all but the last, which is dn_pred_masks
            out["dn_outputs"] = sets(dn_logits, dn_bboxes, dn_corners, dn_refs,
                                     dn_masks_l and dn_masks_l[:-1])
            if dn_masks_l is not None:
                out["dn_pred_masks"] = dn_masks_l[-1]
            out["dn_pre_outputs"] = {"pred_logits": dn_pre_logits, "pred_boxes": dn_pre_bboxes}
            out["dn_meta"] = {"num_dn": num_dn, "num_group": num_group,
                              "positive": dn["positive"], "valid": dn["valid"],
                              "gt_index": dn["gt_index"]}
        return out
