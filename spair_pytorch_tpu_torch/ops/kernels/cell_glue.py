"""The per-cell glue of ``models/latents.py::cell_step``: the CUDA kernels,
their plain versions, autograd.

``cell_step`` runs every head of a front's cells: four MLPs and the glimpse
crop's two einsums, and between them chains of small elementwise operations
(the latent math, the box's affine maps, the crop's hat weights, the
assembly of each MLP's input). Those chains are five segments, each one
``torch.autograd.Function`` here whose forward and backward are one kernel
each on CUDA tensors (``csrc/cell_glue.cu``):

1. ``box_in``: cat(feat, context) in the compute dtype, the box MLP's input,
   and the same in float32 (``fc``, read by ``attr_z``).
2. ``box``: the box head's 8 S columns and the box noise -> the posterior
   (mean, std) of the four box logits after ``freeze_learning``, ``box``
   (x-first), ``z_where`` and the crop's hat weights wy (N, oh, H) and
   wx (N, ow, W) in the compute dtype.
3. ``attr_z``: the encoder's latent and the attr noise -> attr (mean, std)
   and ``attr``; the z MLP's input cat(shared(feat), shared(context),
   shared(passthru), box, attr) in the compute dtype; ``fc`` passed on to
   ``depth_obj`` (``fc3``).
4. ``depth_obj``: the z head's 2 columns and the depth noise -> depth
   (mean, std) after ``freeze_learning`` and ``depth``; the obj MLP's input
   cat(shared(feat), shared(context), passthru2, box, attr, depth).
5. ``pres``: the obj head and the presence noise -> the presence
   probability (``freeze_learning``, the +-10 clamp, the sigmoid, and with
   ``stick`` the slot offsets and the cumulative product) and the context
   vector [box, attr, depth, pres] per slot.

Each segment has a plain version in this module: ``<seg>_plain`` is
today's PyTorch composition (what ``cell_step`` ran before the kernels) and
``<seg>_backward_plain`` its VJP written out as tensor code, with
autograd's own rules: ``torch.clamp`` passes the gradient on its closed
range, ``abs`` has the derivative ``sgn`` (0 at 0), the sigmoid's is
``aten.sigmoid_backward``, and a tensor's cotangents are summed in the
order autograd sums them (the module docstring of ``cell_step``), so on
CPU tensors ``cell_step`` computes today's outputs and gradients bit for
bit. The raw entries ``<seg>_forward`` / ``<seg>_backward`` run the plain
versions on CPU tensors and the kernels on CUDA tensors, or raise; each
counts its launches (``.launches``, in ``parallel/captured.py::COUNTED``).

The feat and context cotangents of the three MLP inputs that hold them
meet in the kernels, not in autograd: ``depth_obj``'s backward returns
its part as the cotangent of ``fc3``, ``attr_z``'s adds its own to it as
the cotangent of ``fc``, and ``box_in``'s adds the box MLP's, the order
in which autograd summed them before.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from spair_pytorch_tpu_torch.ops.kernels.composite import (_device_of,
                                                           _raise_on,
                                                           load_library)
from spair_pytorch_tpu_torch.ops.math import (freeze_learning,
                                              latent_to_mean_std)
from spair_pytorch_tpu_torch.ops.stn import _source_coords_crop, crop_weights

F32 = torch.float32
# tensor slots of one launch's arguments (csrc/cell_glue.cu kTens)
N_TENSORS = 16
# the crop's glimpse rows and columns one block of the box kernels holds
# (csrc/cell_glue.cu kMaxRows)
MAX_CROP_ROWS = 1024
# kernels in csrc/cell_glue.cu's entry point, by segment and direction
KERNELS = ("box_in_fwd", "box_in_bwd", "box_fwd", "box_bwd", "attr_z_fwd",
           "attr_z_bwd", "depth_obj_fwd", "depth_obj_bwd", "pres_fwd",
           "pres_bwd")


@dataclass(frozen=True)
class Geometry:
    """What the box segment needs of the configuration: the image and
    glimpse sides, the grid's cell in pixels, the anchor and the ranges of
    the box's affine maps."""
    image_hw: Tuple[int, int]
    object_hw: Tuple[int, int]
    cell_px: Tuple[int, int]
    anchor_hw: Tuple[int, int]
    min_yx: float
    max_yx: float
    min_hw: float
    max_hw: float


def geometry_of(cfg, geom) -> Geometry:
    return Geometry(tuple(cfg.image_shape[1:]), tuple(cfg.object_shape),
                    tuple(geom[2]), tuple(cfg.anchor_shape), cfg.min_yx,
                    cfg.max_yx, cfg.min_hw, cfg.max_hw)


def _shared(t, s):
    """(B, K, D) -> (B, K, S, D), one copy a slot (a view)."""
    b, k = t.shape[:2]
    return t[:, :, None].expand(b, k, s, t.shape[-1])


def _slot_sum(t):
    """The VJP of ``_shared``: (B, K, S, D) summed over the slots."""
    return t.sum(2, keepdim=True)[:, :, 0]


def _where(mask, g):
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))


def _inside(v, lo, hi):
    """Where ``torch.clamp(v, lo, hi)`` passes the gradient."""
    return (v >= lo) & (v <= hi)


def _sigmoid_bwd(g, y):
    return torch.ops.aten.sigmoid_backward(g, y)


def _add(a, b):
    """a + b, either of which may be None (a zero cotangent)."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _wide(t):
    """A head output or cotangent as the latent math takes it: bf16 widened
    to float32 (the MLPs' promotion), float32 and float64 as they are."""
    if t is None or t.dtype in (F32, torch.float64):
        return t
    return t.to(F32)


# ---------------------------------------------------------------------------
# 1. box_in


def box_in_plain(feat, context, dtype=None):
    """feat (B, K, F), context (B, K, Cc) float32 -> (x, fc): the box MLP's
    input (B, K, F + Cc) in ``dtype`` (float32 for None) and the same in
    float32."""
    fc = torch.cat([feat, context], dim=-1)
    return (fc.clone() if dtype is None else fc.to(dtype)), fc


def box_in_backward_plain(dx, dfc, n_feat: int):
    """(dfeat, dcontext) float32: dfc, which holds the z and obj MLPs'
    parts, plus the box MLP's dx."""
    d = _add(dfc, _wide(dx))
    return d[..., :n_feat], d[..., n_feat:]


# ---------------------------------------------------------------------------
# 2. box


def _box_chain(hb, noise, tw, cell_hw, g: Geometry, s: int):
    """The box segment's forward as tensor code, every intermediate the
    backward needs."""
    b, k = hb.shape[:2]
    lat = _wide(hb).reshape(b, k, s, 8)
    log_std = torch.chunk(lat, 2, dim=-1)[1]
    mean, std = latent_to_mean_std(lat)
    mean, std = freeze_learning(mean, tw), freeze_learning(std, tw)
    nz = noise.reshape(b, k, s, 4)
    logits = mean + std * nz  # order (cy, cx, h, w)
    # one clamped sigmoid a component, as cell_step took them: on the CPU
    # a sigmoid's rounding follows the layout it runs on
    cy_s, cx_s, h_s, w_s = (torch.sigmoid(torch.clamp(t, -10.0, 10.0))
                            for t in torch.split(logits, 1, dim=-1))
    sig = torch.cat([cy_s, cx_s, h_s, w_s], dim=-1)
    img_h, img_w = g.image_hw
    yx_range, hw_range = g.max_yx - g.min_yx, g.max_hw - g.min_hw
    cell_y = yx_range * cy_s + g.min_yx
    cell_x = yx_range * cx_s + g.min_yx
    height = hw_range * h_s + g.min_hw
    width = hw_range * w_s + g.min_hw
    box = torch.cat([cell_x, cell_y, width, height], dim=-1)  # x-first
    ys = height * g.anchor_hw[0] / img_h
    xs = width * g.anchor_hw[1] / img_w
    h_idx = cell_hw[:, 0].to(F32)[None, :, None, None]
    w_idx = cell_hw[:, 1].to(F32)[None, :, None, None]
    yt = (g.cell_px[0] / img_h) * (cell_y + h_idx)
    xt = (g.cell_px[1] / img_w) * (cell_x + w_idx)
    z_where = torch.cat([xt, yt, xs, ys], dim=-1)
    return dict(log_std=log_std, mean=mean, std=std, nz=nz, logits=logits,
                sig=sig, box=box, z_where=z_where)


def box_plain(hb, noise, tw, cell_hw, g: Geometry, s: int, dtype=None):
    """hb (B, K, 8 S): the box head's columns, as the MLP made them; noise
    (B, K, 4 S) float32; tw the training wheel (0-d); cell_hw (K, 2) ->
    (means, stds, box, z_where, wy, wx): the four box logits' posterior
    means and stds after ``freeze_learning``, each (B, K, S) float32 in the
    order (cy, cx, height, width); box [x, y, w, h] and z_where
    [xt, yt, xs, ys], (B, K, S, 4) float32; the crop's hat weights wy
    (B, K S, oh, H) and wx (B, K S, ow, W) in ``dtype``."""
    b, k = hb.shape[:2]
    c = _box_chain(hb, noise, tw, cell_hw, g, s)
    wy, wx = crop_weights(c["z_where"].reshape(b, k * s, 4), g.object_hw,
                          g.image_hw)
    if dtype is not None:
        wy, wx = wy.to(dtype), wx.to(dtype)
    means = tuple(c["mean"][..., i].clone() for i in range(4))
    stds = tuple(c["std"][..., i].clone() for i in range(4))
    return means, stds, c["box"], c["z_where"], wy, wx


def _crop_vjp(t, scale, dw, out_size: int, in_size: int):
    """(dt, dscale) of the hat weights ``_hat(clamp(_source_coords_crop(t,
    scale)))`` for their cotangent dw (..., out, in), as autograd takes
    them: the clamps' closed ranges, ``sgn`` for the derivative of
    ``abs``. Each row has at most two taps with a nonzero derivative."""
    src = _source_coords_crop(t, scale, out_size, in_size)
    sy = torch.clamp(src, 0.0, in_size - 1)
    a = torch.arange(in_size, dtype=F32, device=t.device)
    d = sy[..., None] - a
    pre = 1.0 - torch.abs(d)
    g = _where(pre >= 0.0, dw)
    dsrc = ((-g) * torch.sgn(d)).sum(-1, keepdim=True)[..., 0]
    dsrc = _where(_inside(src, 0.0, in_size - 1), dsrc)
    dx = dsrc / 2.0 * (in_size - 1)
    j = torch.arange(out_size, dtype=F32, device=t.device)
    u_out = 2.0 * j / (out_size - 1) - 1.0
    dscale = (dx * u_out).sum(-1, keepdim=True)[..., 0]
    dt = dx.sum(-1, keepdim=True)[..., 0] * 2.0
    return dt, dscale


def box_backward_plain(hb, noise, tw, cell_hw, g: Geometry, s: int,
                       dmeans, dstds, dbox, dzw, dwy, dwx):
    """The VJP of ``box_plain``: d hb (B, K, 8 S) in hb's dtype. Any
    cotangent may be None (zero); dmeans and dstds are 4-tuples of them."""
    b, k = hb.shape[:2]
    c = _box_chain(hb, noise, tw, cell_hw, g, s)
    img_h, img_w = g.image_hw
    oh, ow = g.object_hw
    zw = c["z_where"].reshape(b, k * s, 4)
    xt, yt, xs, ys = zw.unbind(-1)
    zeros = torch.zeros_like(zw)
    dwy = zeros.new_zeros(b, k * s, oh, img_h) if dwy is None else _wide(dwy)
    dwx = zeros.new_zeros(b, k * s, ow, img_w) if dwx is None else _wide(dwx)
    dyt, dys = _crop_vjp(yt, ys, dwy, oh, img_h)
    dxt, dxs = _crop_vjp(xt, xs, dwx, ow, img_w)
    dz = _add(dzw, torch.stack([dxt, dyt, dxs, dys], -1).reshape(b, k, s, 4))
    dxt, dyt, dxs, dys = torch.split(dz, 1, dim=-1)
    dbox = torch.zeros_like(dz) if dbox is None else dbox
    dbx, dby, dbw, dbh = torch.split(dbox, 1, dim=-1)
    d_cell_y = dby + dyt * (g.cell_px[0] / img_h)
    d_cell_x = dbx + dxt * (g.cell_px[1] / img_w)
    d_height = dbh + dys / img_h * g.anchor_hw[0]
    d_width = dbw + dxs / img_w * g.anchor_hw[1]
    yx_range, hw_range = g.max_yx - g.min_yx, g.max_hw - g.min_hw
    dsig = torch.cat([d_cell_y * yx_range, d_cell_x * yx_range,
                      d_height * hw_range, d_width * hw_range], dim=-1)
    dlogits = _where(_inside(c["logits"], -10.0, 10.0),
                     _sigmoid_bwd(dsig, c["sig"]))

    def stacked(ds):
        if all(d is None for d in ds):
            return None
        return torch.stack([noise.new_zeros((b, k, s)) if d is None else d
                            for d in ds], -1)
    dmean = _add(dlogits, stacked(dmeans))
    dstd = _add(dlogits * c["nz"], stacked(dstds))
    q = 1.0 - tw
    dmean_raw, dstd_raw = dmean * q, dstd * q
    std_sig = torch.sigmoid(torch.clamp(c["log_std"], -10.0, 10.0))
    dls = _where(_inside(c["log_std"], -10.0, 10.0),
                 _sigmoid_bwd(dstd_raw * 2.0, std_sig))
    return torch.cat([dmean_raw, dls], -1).reshape(b, k, 8 * s).to(hb.dtype)


# ---------------------------------------------------------------------------
# 3. attr_z


def attr_z_plain(lat, noise, fc, passthru, box, dtype=None):
    """lat (B, K S, 2A): the encoder's latent as it made it; noise (B, K,
    S A) float32; fc (B, K, F + Cc) float32; passthru (B, K, P) as the box
    MLP made it; box (B, K, S, 4) float32 -> (attr_mean, attr_std, attr,
    z_in, fc3): the first three (B, K, S, A) float32, z_in (B, K, S,
    F + Cc + P + 4 + A) in ``dtype``, fc3 a copy of fc."""
    b, k, s = box.shape[:3]
    mean, std = latent_to_mean_std(_wide(lat).reshape(b, k, s, -1))
    attr = mean + std * noise.reshape(b, k, s, -1)
    z_in = torch.cat([_shared(fc, s), _shared(_wide(passthru), s), box,
                      attr], dim=-1)
    if dtype is not None:
        z_in = z_in.to(dtype)
    return mean.clone(), std.clone(), attr, z_in, fc.clone()


def attr_z_backward_plain(lat, noise, dmean, dstd, dattr, dz_in, dfc3,
                          n_shared: int, n_pass: int, pass_dtype):
    """The VJP of ``attr_z_plain``: (dlat (B, K S, 2A) in lat's dtype,
    dpassthru (B, K, P) in ``pass_dtype``, dfc (B, K, F + Cc), dbox (B, K,
    S, 4)), float32 but where said. dfc is dfc3 (the obj MLP's part) plus
    this segment's; dattr holds what autograd summed from attr's other
    consumers, and the z MLP's part is added to it last."""
    b, k = noise.shape[:2]
    a = lat.shape[-1] // 2
    s = noise.shape[-1] // a
    latf = _wide(lat).reshape(b, k, s, 2 * a)
    dz = (noise.new_zeros((b, k, s, n_shared + n_pass + 4 + a))
          if dz_in is None else _wide(dz_in))
    o_pass, o_box = n_shared, n_shared + n_pass
    o_attr = o_box + 4
    dfc = _add(dfc3, _slot_sum(dz[..., :o_pass]))
    dpass = _slot_sum(dz[..., o_pass:o_box]).to(pass_dtype)
    dbox = dz[..., o_box:o_attr]
    d_attr = _add(dattr, dz[..., o_attr:])
    dmean_t = _add(dmean, d_attr)
    dstd_t = _add(dstd, d_attr * noise.reshape(b, k, s, a))
    log_std = latf[..., a:]
    sig = torch.sigmoid(torch.clamp(log_std, -10.0, 10.0))
    dls = _where(_inside(log_std, -10.0, 10.0),
                 _sigmoid_bwd(dstd_t * 2.0, sig))
    dlat = torch.cat([dmean_t, dls], -1).reshape(lat.shape).to(lat.dtype)
    return dlat, dpass, dfc, dbox


# ---------------------------------------------------------------------------
# 4. depth_obj


def _depth_chain(dl, noise, tw):
    b, k, s = dl.shape[:3]
    lat = _wide(dl)
    mean, std = latent_to_mean_std(lat)
    mean, std = freeze_learning(mean, tw), freeze_learning(std, tw)
    logit = mean + std * noise.reshape(b, k, s, 1)
    sig = torch.sigmoid(torch.clamp(logit, -10.0, 10.0))
    return dict(log_std=lat[..., 1:], mean=mean, std=std, logit=logit,
                sig=sig, depth=4.0 * sig)


def depth_obj_plain(dl, pass2, noise, tw, fc3, box, attr, dtype=None):
    """dl (B, K, S, 2) and pass2 (B, K, S, P): the z MLP's heads as it made
    them; noise (B, K, S) float32; fc3 (B, K, F + Cc), box (B, K, S, 4),
    attr (B, K, S, A) float32 -> (depth_mean, depth_std, depth, obj_in):
    the first three (B, K, S) float32, obj_in (B, K, S, F + Cc + P + 4 + A
    + 1) in ``dtype``."""
    s = box.shape[2]
    c = _depth_chain(dl, noise, tw)
    obj_in = torch.cat([_shared(fc3, s), _wide(pass2), box, attr,
                        c["depth"]], dim=-1)
    if dtype is not None:
        obj_in = obj_in.to(dtype)
    return (c["mean"][..., 0].clone(), c["std"][..., 0].clone(),
            c["depth"][..., 0].clone(), obj_in)


def depth_obj_backward_plain(dl, pass_dtype, noise, tw, dmean, dstd, ddepth,
                             dobj_in, n_shared: int, n_pass: int,
                             n_attr: int):
    """The VJP of ``depth_obj_plain``: (d dl in dl's dtype, dpass2 in
    ``pass_dtype``, dfc3, dbox, dattr), float32 but where said. ddepth
    holds what autograd summed from depth's other consumers; the obj MLP's
    part is added to it last."""
    b, k, s = dl.shape[:3]
    c = _depth_chain(dl, noise, tw)
    dob = (noise.new_zeros((b, k, s, n_shared + n_pass + 4 + n_attr + 1))
           if dobj_in is None else _wide(dobj_in))
    o_box = n_shared + n_pass
    o_attr = o_box + 4
    o_depth = o_attr + n_attr
    dfc3 = _slot_sum(dob[..., :n_shared])
    dpass2 = dob[..., n_shared:o_box].to(pass_dtype)
    d_depth = _add(None if ddepth is None else ddepth[..., None],
                   dob[..., o_depth:])
    dlogit = _where(_inside(c["logit"], -10.0, 10.0),
                    _sigmoid_bwd(d_depth * 4.0, c["sig"]))
    dmean_t = _add(dlogit, None if dmean is None else dmean[..., None])
    dstd_t = _add(dlogit * noise.reshape(b, k, s, 1),
                  None if dstd is None else dstd[..., None])
    q = 1.0 - tw
    sig_ls = torch.sigmoid(torch.clamp(c["log_std"], -10.0, 10.0))
    dls = _where(_inside(c["log_std"], -10.0, 10.0),
                 _sigmoid_bwd(dstd_t * q * 2.0, sig_ls))
    ddl = torch.cat([dmean_t * q, dls], -1).to(dl.dtype)
    return ddl, dpass2, dfc3, dob[..., o_box:o_attr], dob[..., o_attr:o_depth]


# ---------------------------------------------------------------------------
# 5. pres


def _pres_chain(po, noise, tw, stick: bool):
    b, k, s = po.shape[:3]
    logit = freeze_learning(_wide(po), tw)
    if stick:
        # ordered stick-breaking: later slots start biased off
        offset = -2.0 * torch.arange(s, dtype=logit.dtype,
                                     device=logit.device)
        logit = logit + offset[None, None, :, None]
    prob = torch.sigmoid(torch.clamp(logit, -10.0, 10.0)
                         + noise.reshape(b, k, s, 1))
    out = torch.cumprod(prob, dim=2) if stick else prob
    return logit, prob, out


def pres_plain(po, noise, tw, box, attr, depth, stick: bool):
    """po (B, K, S, 1): the obj head as the MLP made it; noise (B, K, S)
    float32; box (B, K, S, 4), attr (B, K, S, A), depth (B, K, S) float32
    -> (pres (B, K, S), ctx_vec (B, K, S (A + 6))) float32: the presence
    probability (the relaxed sample is the probability itself) and the
    context vector each cell shows its neighbours."""
    b, k = po.shape[:2]
    _, _, pres = _pres_chain(po, noise, tw, stick)
    ctx_vec = torch.cat([box, attr, depth[..., None], pres], dim=-1)
    return pres[..., 0].clone(), ctx_vec.reshape(b, k, -1).clone()


def pres_backward_plain(po, noise, tw, dpres, dctx, stick: bool,
                        n_attr: int):
    """The VJP of ``pres_plain``: (dpo in po's dtype, dbox, dattr, ddepth)
    float32. dpres holds what autograd summed from the presence outputs;
    the context vector's part is added to it last."""
    b, k, s = po.shape[:3]
    logit, prob, out = _pres_chain(po, noise, tw, stick)
    dc = (noise.new_zeros((b, k, s, n_attr + 6)) if dctx is None
          else dctx.reshape(b, k, s, n_attr + 6))
    d_out = _add(None if dpres is None else dpres[..., None],
                 dc[..., n_attr + 5:])
    if stick:
        # cumprod's VJP as autograd takes it (no probability is 0: the
        # clamped logit plus the bounded logistic noise keeps it above it)
        w = out * d_out
        d_prob = w.flip(2).cumsum(2).flip(2).div(prob)
    else:
        d_prob = d_out
    dlogit = _where(_inside(logit, -10.0, 10.0), _sigmoid_bwd(d_prob, prob))
    dpo = (dlogit * (1.0 - tw)).to(po.dtype)
    return (dpo, dc[..., :4], dc[..., 4:4 + n_attr],
            dc[..., 4 + n_attr])


# ---------------------------------------------------------------------------
# the kernels' launches


class _Ten(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sk", ctypes.c_longlong), ("ss", ctypes.c_longlong),
                ("bf16", ctypes.c_int), ("pad", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_int) for name in (
                    "b", "k", "s", "nf", "nc", "np", "na", "oh", "ow", "ih",
                    "iw", "stick")]
                + [(name, ctypes.c_float) for name in (
                    "yx_range", "min_yx", "hw_range", "min_hw", "anchor_h",
                    "anchor_w", "cell_h", "cell_w")]
                + [("tw", ctypes.c_void_p), ("cell_hw", ctypes.c_void_p),
                   ("t", _Ten * N_TENSORS)])


_DTYPES = {F32: 0, torch.bfloat16: 1}


def _ten(t, b: int, k: int, s: int, d: int):
    """A tensor argument: ``t`` holds (b, k, s, d) values, slot-major in
    its trailing dims ((b, k, s * d), (b, k, s, d) or (b, k, s) for d = 1),
    columns contiguous; other layouts are made contiguous first. Returns
    (the tensor kept alive, _Ten)."""
    if t is None:
        return None, _Ten()
    if t.dtype not in _DTYPES:
        raise TypeError(f"the cell glue kernels take float32 or bfloat16 "
                        f"tensors, got {t.dtype}")
    want = (b, k, s * d)
    if t.dim() == 4 and tuple(t.shape) == (b, k, s, d):
        v = t
    elif tuple(t.shape) == want or (d == 1 and tuple(t.shape) == (b, k, s)):
        v = t.unflatten(2, (s, d)) if t.dim() == 3 else t
    else:
        raise ValueError(f"tensor of shape {tuple(t.shape)} where "
                         f"{(b, k, s, d)} was expected")
    if d > 1 and v.stride(3) != 1:
        v = v.contiguous()
    sb, sk, ss = v.stride()[:3]
    return v, _Ten(v.data_ptr(), sb, sk, ss, _DTYPES[v.dtype], 0)


def _launch(which: str, tensors, dims, geom: Optional[Geometry], tw=None,
            cell_hw=None, stick=False):
    """One kernel of ``csrc/cell_glue.cu`` on the current stream.
    ``tensors``: (tensor or None, (s, d)) in the kernel's slot order, each
    over the (b, k) rows of ``dims`` = (b, k, s, nf, nc, np, na)."""
    b, k = dims[:2]
    device = next(t.device for t, _ in tensors if t is not None)
    args = _Args()
    for name, v in zip(("b", "k", "s", "nf", "nc", "np", "na"), dims):
        setattr(args, name, v)
    if geom is not None:
        args.oh, args.ow = geom.object_hw
        args.ih, args.iw = geom.image_hw
        args.yx_range = geom.max_yx - geom.min_yx
        args.min_yx = geom.min_yx
        args.hw_range = geom.max_hw - geom.min_hw
        args.min_hw = geom.min_hw
        args.anchor_h, args.anchor_w = geom.anchor_hw
        args.cell_h = geom.cell_px[0] / geom.image_hw[0]
        args.cell_w = geom.cell_px[1] / geom.image_hw[1]
    args.stick = int(stick)
    keep = []
    for i, (t, (s, d)) in enumerate(tensors):
        v, args.t[i] = _ten(t, b, k, s, d)
        keep.append(v)
    if tw is not None:
        args.tw = tw.data_ptr()
    if cell_hw is not None:
        args.cell_hw = cell_hw.data_ptr()
    lib = load_library("cell_glue")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spair_cell_glue(KERNELS.index(which), ctypes.byref(args),
                                  stream)
    _raise_on(lib, err, which)
    del keep


def _out(shape, dtype, device):
    return torch.empty(shape, dtype=F32 if dtype is None else dtype,
                       device=device)


def _tw_tensor(tw, device):
    if not torch.is_tensor(tw) or tw.dtype != F32 or tw.numel() != 1 \
            or tw.device != device:
        raise ValueError(f"the cell glue kernels take the training wheel "
                         f"as a one-element float32 tensor on {device}")
    return tw


def _cell_hw(cell_hw, k: int, device):
    if tuple(cell_hw.shape) != (k, 2) or cell_hw.device != device:
        raise ValueError(f"cell_hw must be ({k}, 2) on {device}, got "
                         f"{tuple(cell_hw.shape)} on {cell_hw.device}")
    return cell_hw.to(torch.int64).contiguous()


def _check_head(t, name):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: the cell glue kernels take float32 or "
                        f"bfloat16 head outputs, got {t.dtype}")


def box_in_forward(feat, context, dtype=None):
    """``box_in_plain``: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    device = _device_of([feat, context], "box_in_forward")
    if device.type == "cpu":
        return box_in_plain(feat, context, dtype)
    b, k, nf = feat.shape
    nc = context.shape[-1]
    for name, t in (("feat", feat), ("context", context)):
        if t.dtype != F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    x = _out((b, k, nf + nc), dtype, device)
    fc = _out((b, k, nf + nc), None, device)
    _launch("box_in_fwd", [(feat, (1, nf)), (context, (1, nc)),
                           (x, (1, nf + nc)), (fc, (1, nf + nc))],
            (b, k, 1, nf, nc, 0, 0), None)
    box_in_forward.launches += 1
    return x, fc


def box_in_backward(dx, dfc, n_feat: int, shape):
    """``box_in_backward_plain``; ``shape`` (b, k, F + Cc) for when both
    cotangents are None."""
    present = [t for t in (dx, dfc) if t is not None]
    if not present:
        return None, None
    device = _device_of(present, "box_in_backward")
    if device.type == "cpu":
        return box_in_backward_plain(dx, dfc, n_feat)
    b, k, w = shape
    dfeat = _out((b, k, n_feat), None, device)
    dctx = _out((b, k, w - n_feat), None, device)
    _launch("box_in_bwd", [(dx, (1, w)), (dfc, (1, w)), (dfeat, (1, n_feat)),
                           (dctx, (1, w - n_feat))],
            (b, k, 1, n_feat, w - n_feat, 0, 0), None)
    box_in_backward.launches += 1
    return dfeat, dctx


box_in_forward.launches = box_in_backward.launches = 0


def _check_crop(g: Geometry):
    oh, ow = g.object_hw
    if min(oh, ow) < 2 or oh + ow > MAX_CROP_ROWS or min(g.image_hw) < 1:
        raise ValueError(f"glimpse sides {g.object_hw} out of the box "
                         f"kernels' range (2 to, together, {MAX_CROP_ROWS})")


def box_forward(hb, noise, tw, cell_hw, g: Geometry, s: int, dtype=None):
    """``box_plain``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    device = _device_of([hb, noise, tw, cell_hw], "box_forward")
    if device.type == "cpu":
        return box_plain(hb, noise, tw, cell_hw, g, s, dtype)
    _check_head(hb, "box head")
    _check_crop(g)
    b, k = hb.shape[:2]
    oh, ow = g.object_hw
    ih, iw = g.image_hw
    tw = _tw_tensor(tw, device)
    cell_hw = _cell_hw(cell_hw, k, device)
    small = [_out((b, k, s), None, device) for _ in range(8)]
    box = _out((b, k, s, 4), None, device)
    zw = _out((b, k, s, 4), None, device)
    wy = _out((b, k * s, oh, ih), dtype, device)
    wx = _out((b, k * s, ow, iw), dtype, device)
    _launch("box_fwd", [(hb, (s, 8)), (noise, (s, 4))]
            + [(t, (s, 1)) for t in small]
            + [(box, (s, 4)), (zw, (s, 4)), (wy.view(b, k, -1), (s, oh * ih)),
               (wx.view(b, k, -1), (s, ow * iw))],
            (b, k, s, 0, 0, 0, 0), g, tw, cell_hw)
    box_forward.launches += 1
    return tuple(small[:4]), tuple(small[4:]), box, zw, wy, wx


def box_backward(hb, noise, tw, cell_hw, g: Geometry, s: int, dmeans, dstds,
                 dbox, dzw, dwy, dwx):
    """``box_backward_plain``: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    device = _device_of([hb, noise, tw, cell_hw], "box_backward")
    if device.type == "cpu":
        return box_backward_plain(hb, noise, tw, cell_hw, g, s, dmeans, dstds,
                                  dbox, dzw, dwy, dwx)
    b, k = hb.shape[:2]
    oh, ow = g.object_hw
    ih, iw = g.image_hw
    dhb = torch.empty((b, k, 8 * s), dtype=hb.dtype, device=device)
    dwy, dwx = (None if d is None else d.reshape(b, k, -1) for d in (dwy, dwx))
    _launch("box_bwd", [(hb, (s, 8)), (noise, (s, 4))]
            + [(t, (s, 1)) for t in (*dmeans, *dstds)]
            + [(dbox, (s, 4)), (dzw, (s, 4)), (dwy, (s, oh * ih)),
               (dwx, (s, ow * iw)), (dhb, (s, 8))],
            (b, k, s, 0, 0, 0, 0), g, _tw_tensor(tw, device),
            _cell_hw(cell_hw, k, device))
    box_backward.launches += 1
    return dhb


box_forward.launches = box_backward.launches = 0


def attr_z_forward(lat, noise, fc, passthru, box, dtype=None):
    """``attr_z_plain``: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    device = _device_of([lat, noise, fc, passthru, box], "attr_z_forward")
    if device.type == "cpu":
        return attr_z_plain(lat, noise, fc, passthru, box, dtype)
    _check_head(lat, "encoder")
    _check_head(passthru, "box passthrough")
    b, k, s = box.shape[:3]
    w1, npass = fc.shape[-1], passthru.shape[-1]
    na = lat.shape[-1] // 2
    wz = w1 + npass + 4 + na
    mean, std, attr = (_out((b, k, s, na), None, device) for _ in range(3))
    z_in = _out((b, k, s, wz), dtype, device)
    fc3 = _out((b, k, w1), None, device)
    _launch("attr_z_fwd", [(lat.reshape(b, k, s * 2 * na), (s, 2 * na)),
                           (noise, (s, na)), (fc, (1, w1)),
                           (passthru, (1, npass)), (box, (s, 4)),
                           (mean, (s, na)), (std, (s, na)), (attr, (s, na)),
                           (z_in, (s, wz)), (fc3, (1, w1))],
            (b, k, s, w1, 0, npass, na), None)
    attr_z_forward.launches += 1
    return mean, std, attr, z_in, fc3


def attr_z_backward(lat, noise, dmean, dstd, dattr, dz_in, dfc3,
                    n_shared: int, n_pass: int, pass_dtype):
    """``attr_z_backward_plain``: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    device = _device_of([lat, noise], "attr_z_backward")
    if device.type == "cpu":
        return attr_z_backward_plain(lat, noise, dmean, dstd, dattr, dz_in,
                                     dfc3, n_shared, n_pass, pass_dtype)
    b, k = noise.shape[:2]
    na = lat.shape[-1] // 2
    s = noise.shape[-1] // na
    wz = n_shared + n_pass + 4 + na
    dlat = torch.empty(lat.shape, dtype=lat.dtype, device=device)
    dpass = _out((b, k, n_pass), pass_dtype, device)
    dfc = _out((b, k, n_shared), None, device)
    dbox = _out((b, k, s, 4), None, device)
    _launch("attr_z_bwd", [(lat.reshape(b, k, s * 2 * na), (s, 2 * na)),
                           (noise, (s, na)), (dmean, (s, na)),
                           (dstd, (s, na)), (dattr, (s, na)),
                           (dz_in, (s, wz)), (dfc3, (1, n_shared)),
                           (dlat.reshape(b, k, s * 2 * na), (s, 2 * na)),
                           (dpass, (1, n_pass)), (dfc, (1, n_shared)),
                           (dbox, (s, 4))],
            (b, k, s, n_shared, 0, n_pass, na), None)
    attr_z_backward.launches += 1
    return dlat, dpass, dfc, dbox


attr_z_forward.launches = attr_z_backward.launches = 0


def depth_obj_forward(dl, pass2, noise, tw, fc3, box, attr, dtype=None):
    """``depth_obj_plain``: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    device = _device_of([dl, pass2, noise, tw, fc3, box, attr],
                        "depth_obj_forward")
    if device.type == "cpu":
        return depth_obj_plain(dl, pass2, noise, tw, fc3, box, attr, dtype)
    _check_head(dl, "z head")
    _check_head(pass2, "z passthrough")
    b, k, s = box.shape[:3]
    w1, npass, na = fc3.shape[-1], pass2.shape[-1], attr.shape[-1]
    wo = w1 + npass + 4 + na + 1
    mean, std, depth = (_out((b, k, s), None, device) for _ in range(3))
    obj_in = _out((b, k, s, wo), dtype, device)
    _launch("depth_obj_fwd", [(dl, (s, 2)), (pass2, (s, npass)),
                              (noise, (s, 1)), (fc3, (1, w1)), (box, (s, 4)),
                              (attr, (s, na)), (mean, (s, 1)), (std, (s, 1)),
                              (depth, (s, 1)), (obj_in, (s, wo))],
            (b, k, s, w1, 0, npass, na), None, _tw_tensor(tw, device))
    depth_obj_forward.launches += 1
    return mean, std, depth, obj_in


def depth_obj_backward(dl, pass_dtype, noise, tw, dmean, dstd, ddepth,
                       dobj_in, n_shared: int, n_pass: int, n_attr: int):
    """``depth_obj_backward_plain``: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    device = _device_of([dl, noise, tw], "depth_obj_backward")
    if device.type == "cpu":
        return depth_obj_backward_plain(dl, pass_dtype, noise, tw, dmean,
                                        dstd, ddepth, dobj_in, n_shared,
                                        n_pass, n_attr)
    b, k, s = dl.shape[:3]
    wo = n_shared + n_pass + 4 + n_attr + 1
    ddl = torch.empty((b, k, s, 2), dtype=dl.dtype, device=device)
    dpass2 = _out((b, k, s, n_pass), pass_dtype, device)
    dfc3 = _out((b, k, n_shared), None, device)
    dbox = _out((b, k, s, 4), None, device)
    dattr = _out((b, k, s, n_attr), None, device)
    _launch("depth_obj_bwd", [(dl, (s, 2)), (noise, (s, 1)), (dmean, (s, 1)),
                              (dstd, (s, 1)), (ddepth, (s, 1)),
                              (dobj_in, (s, wo)), (ddl, (s, 2)),
                              (dpass2, (s, n_pass)), (dfc3, (1, n_shared)),
                              (dbox, (s, 4)), (dattr, (s, n_attr))],
            (b, k, s, n_shared, 0, n_pass, n_attr), None,
            _tw_tensor(tw, device))
    depth_obj_backward.launches += 1
    return ddl, dpass2, dfc3, dbox, dattr


depth_obj_forward.launches = depth_obj_backward.launches = 0


def pres_forward(po, noise, tw, box, attr, depth, stick: bool):
    """``pres_plain``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    device = _device_of([po, noise, tw, box, attr, depth], "pres_forward")
    if device.type == "cpu":
        return pres_plain(po, noise, tw, box, attr, depth, stick)
    _check_head(po, "obj head")
    b, k, s = box.shape[:3]
    na = attr.shape[-1]
    pres = _out((b, k, s), None, device)
    ctx_vec = _out((b, k, s * (na + 6)), None, device)
    _launch("pres_fwd", [(po, (s, 1)), (noise, (s, 1)), (box, (s, 4)),
                         (attr, (s, na)), (depth, (s, 1)), (pres, (s, 1)),
                         (ctx_vec, (s, na + 6))],
            (b, k, s, 0, 0, 0, na), None, _tw_tensor(tw, device),
            stick=stick)
    pres_forward.launches += 1
    return pres, ctx_vec


def pres_backward(po, noise, tw, dpres, dctx, stick: bool, n_attr: int):
    """``pres_backward_plain``: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    device = _device_of([po, noise, tw], "pres_backward")
    if device.type == "cpu":
        return pres_backward_plain(po, noise, tw, dpres, dctx, stick, n_attr)
    b, k, s = po.shape[:3]
    dpo = torch.empty((b, k, s, 1), dtype=po.dtype, device=device)
    dbox = _out((b, k, s, 4), None, device)
    dattr = _out((b, k, s, n_attr), None, device)
    ddepth = _out((b, k, s), None, device)
    _launch("pres_bwd", [(po, (s, 1)), (noise, (s, 1)), (dpres, (s, 1)),
                         (dctx, (s, n_attr + 6)), (dpo, (s, 1)),
                         (dbox, (s, 4)), (dattr, (s, n_attr)),
                         (ddepth, (s, 1))],
            (b, k, s, 0, 0, 0, n_attr), None, _tw_tensor(tw, device),
            stick=stick)
    pres_backward.launches += 1
    return dpo, dbox, dattr, ddepth


pres_forward.launches = pres_backward.launches = 0

COUNTED = (box_in_forward, box_in_backward, box_forward, box_backward,
           attr_z_forward, attr_z_backward, depth_obj_forward,
           depth_obj_backward, pres_forward, pres_backward)


# ---------------------------------------------------------------------------
# autograd


class BoxIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, context, dtype):
        ctx.set_materialize_grads(False)
        ctx.n_feat = feat.shape[-1]
        ctx.shape = tuple(feat.shape[:2]) + (feat.shape[-1]
                                             + context.shape[-1],)
        return box_in_forward(feat, context, dtype)

    @staticmethod
    def backward(ctx, dx, dfc):
        return (*box_in_backward(dx, dfc, ctx.n_feat, ctx.shape), None)


class Box(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hb, noise, tw, cell_hw, g, s, dtype):
        ctx.set_materialize_grads(False)
        ctx.g, ctx.s = g, s
        ctx.save_for_backward(hb, noise, tw, cell_hw)
        means, stds, box, zw, wy, wx = box_forward(hb, noise, tw, cell_hw, g,
                                                   s, dtype)
        return (*means, *stds, box, zw, wy, wx)

    @staticmethod
    def backward(ctx, *grads):
        hb, noise, tw, cell_hw = ctx.saved_tensors
        dhb = box_backward(hb, noise, tw, cell_hw, ctx.g, ctx.s, grads[:4],
                           grads[4:8], *grads[8:])
        return dhb, None, None, None, None, None, None


class AttrZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lat, noise, fc, passthru, box, dtype):
        ctx.set_materialize_grads(False)
        ctx.n_shared, ctx.n_pass = fc.shape[-1], passthru.shape[-1]
        ctx.pass_dtype = passthru.dtype
        ctx.save_for_backward(lat, noise)
        return attr_z_forward(lat, noise, fc, passthru, box, dtype)

    @staticmethod
    def backward(ctx, dmean, dstd, dattr, dz_in, dfc3):
        lat, noise = ctx.saved_tensors
        dlat, dpass, dfc, dbox = attr_z_backward(
            lat, noise, dmean, dstd, dattr, dz_in, dfc3, ctx.n_shared,
            ctx.n_pass, ctx.pass_dtype)
        return dlat, None, dfc, dpass, dbox, None


class DepthObj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dl, pass2, noise, tw, fc3, box, attr, dtype):
        ctx.set_materialize_grads(False)
        ctx.dims = (fc3.shape[-1], pass2.shape[-1], attr.shape[-1])
        ctx.pass_dtype = pass2.dtype
        ctx.save_for_backward(dl, noise, tw)
        return depth_obj_forward(dl, pass2, noise, tw, fc3, box, attr, dtype)

    @staticmethod
    def backward(ctx, dmean, dstd, ddepth, dobj_in):
        dl, noise, tw = ctx.saved_tensors
        ddl, dpass2, dfc3, dbox, dattr = depth_obj_backward(
            dl, ctx.pass_dtype, noise, tw, dmean, dstd, ddepth, dobj_in,
            *ctx.dims)
        return ddl, dpass2, None, None, dfc3, dbox, dattr, None


class Pres(torch.autograd.Function):
    @staticmethod
    def forward(ctx, po, noise, tw, box, attr, depth, stick):
        ctx.set_materialize_grads(False)
        ctx.stick, ctx.n_attr = stick, attr.shape[-1]
        ctx.save_for_backward(po, noise, tw)
        return pres_forward(po, noise, tw, box, attr, depth, stick)

    @staticmethod
    def backward(ctx, dpres, dctx):
        po, noise, tw = ctx.saved_tensors
        dpo, dbox, dattr, ddepth = pres_backward(po, noise, tw, dpres, dctx,
                                                 ctx.stick, ctx.n_attr)
        return dpo, None, None, dbox, dattr, ddepth, None
