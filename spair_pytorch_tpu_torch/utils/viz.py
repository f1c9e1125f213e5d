"""Renderer-analysis figures, host side, numpy + matplotlib (the port's own
copy of ``spair_pytorch_tpu/utils/viz.py``; same functions, panels and
titles).

Counterparts of the reference's debug visualizations: the pre-render
component panels (per-object rendered / alpha / importance mosaics, the box
overlay, depth and presence heatmaps), the cropped glimpse grid, the z_attr
min / mean / max heatmaps, and the gradient views of the decoder's output
and of z_attr (``utils/debug.py::generative_grad_views``). Everything here
takes numpy arrays (tensors moved to the host first); the model does no
logging. matplotlib is imported at a figure's first call
(``_require_plt``), so this module imports on a machine without it.
"""

from __future__ import annotations

import numpy as np


def _require_plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_analysis_figure(x, recon, z_where, z_pres, z_depth, batch_idx=0):
    """The reference's renderer-analysis panel (debug_tools.py:53-104):
    input, reconstruction, bbox overlay, presence and depth heatmaps.

    x, recon: (B, C, H, W); z_where: (B, 4, gh, gw) normalized
    [xt, yt, xs, ys] (centers); z_pres, z_depth: (B, 1, gh, gw).
    Returns a matplotlib Figure.
    """
    plt = _require_plt()
    x, recon = np.asarray(x), np.asarray(recon)
    z_where = np.asarray(z_where)
    z_pres, z_depth = np.asarray(z_pres), np.asarray(z_depth)
    b = batch_idx
    h, w = x.shape[-2:]

    fig, axes = plt.subplots(1, 5, figsize=(16, 3.5))
    axes[0].imshow(x[b, 0], cmap="gray", vmin=0, vmax=1)
    axes[0].set_title("input")
    axes[1].imshow(recon[b, 0], cmap="gray", vmin=0, vmax=1)
    axes[1].set_title("reconstruction")

    axes[2].imshow(x[b, 0], cmap="gray", vmin=0, vmax=1)
    gh, gw = z_where.shape[-2:]
    for gy in range(gh):
        for gx in range(gw):
            if z_pres[b, 0, gy, gx] < 0.5:
                continue
            xt, yt, xs, ys = z_where[b, :, gy, gx]
            # (xt, yt) is the box CENTER (reference models.py:373-376;
            # the overlay subtracts half-extent like debug_tools.py:188-190)
            x0, y0 = (xt - xs / 2) * w, (yt - ys / 2) * h
            rect = plt.Rectangle((x0, y0), xs * w, ys * h, fill=False,
                                 edgecolor="lime", linewidth=1)
            axes[2].add_patch(rect)
    axes[2].set_title("predicted boxes (pres>0.5)")

    im3 = axes[3].imshow(z_pres[b, 0], vmin=0, vmax=1, cmap="viridis")
    axes[3].set_title("z_pres")
    fig.colorbar(im3, ax=axes[3], fraction=0.046)
    im4 = axes[4].imshow(z_depth[b, 0], vmin=0, vmax=4, cmap="magma")
    axes[4].set_title("z_depth")
    fig.colorbar(im4, ax=axes[4], fraction=0.046)
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    return fig


def glimpse_grid_figure(glimpses, batch_idx=0, max_cols=11):
    """Grid of cropped input glimpses for one image (the reference's
    plot_cropped_input_images, debug_tools.py:107-139).
    glimpses: (B, N, C, oh, ow)."""
    plt = _require_plt()
    g = np.asarray(glimpses)[batch_idx]
    n = g.shape[0]
    cols = min(max_cols, n)
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols, rows))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        if i < n:
            ax.imshow(g[i, 0], cmap="gray", vmin=0, vmax=1)
        ax.axis("off")
    fig.tight_layout(pad=0.1)
    return fig


def _mosaic(tiles):
    """(gh, gw, oh, ow) per-object tiles -> one (gh*oh, gw*ow) image, the
    reference's double-concatenate layout (debug_tools.py:60-62)."""
    t = np.asarray(tiles)
    gh, gw, oh, ow = t.shape
    return t.transpose(0, 2, 1, 3).reshape(gh * oh, gw * ow)


def _heat(ax, fig, title, data, cmap):
    im = ax.imshow(np.asarray(data), cmap=cmap)
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.03, pad=0.04)


def prerender_components_figure(color, alpha, importance, z_where, z_pres,
                                z_depth, x, batch_idx=0):
    """The reference's ``plot_prerender_components`` (debug_tools.py:53-104):
    a 2x3 panel of (rendered objects, alpha, importance) mosaics over every
    grid cell, plus the bbox overlay (red = present, blue = absent, alpha by
    presence, debug_tools.py:178-195) and z_depth / z_pres heatmaps.

    color/alpha/importance: (B, N, C, oh, ow) from
    models.render.decode_objects;
    z_where: (B, 4, gh, gw) normalized center boxes; z_pres/z_depth:
    (B, 1, gh, gw); x: (B, C, H, W).
    """
    plt = _require_plt()
    b = batch_idx
    gh, gw = np.asarray(z_pres).shape[-2:]
    oh, ow = np.asarray(color).shape[-2:]

    def grid_tiles(t):  # (N, oh, ow) -> (gh, gw, oh, ow)
        return np.asarray(t)[b, :, 0].reshape(gh, gw, oh, ow)

    fig, axes = plt.subplots(2, 3, figsize=(10, 7))
    ax = axes[0, 0]
    ax.imshow(_mosaic(grid_tiles(color)), cmap="gray", vmin=0, vmax=1)
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_title("rendered_obj")
    _heat(axes[0, 1], fig, "alpha", _mosaic(grid_tiles(alpha)), "spring")
    _heat(axes[0, 2], fig, "importance", _mosaic(grid_tiles(importance)),
          "summer")

    # bbox overlay, reference color scheme (debug_tools.py:186-191)
    ax = axes[1, 0]
    xnp = np.asarray(x)
    h, w = xnp.shape[-2:]
    ax.imshow(xnp[b, 0], cmap="gray", vmin=0, vmax=1)
    zw = np.asarray(z_where)
    zp = np.asarray(z_pres)
    for gy in range(gh):
        for gx in range(gw):
            xt, yt, xs, ys = zw[b, :, gy, gx]
            pres = float(np.clip(zp[b, 0, gy, gx], 0.2, 1.0))
            color_rgba = (1, 0, 0, pres) if pres > 0.5 else (0, 0, 1, pres)
            rect = plt.Rectangle(((xt - xs / 2) * w, (yt - ys / 2) * h),
                                 xs * w, ys * h, fill=False,
                                 edgecolor=color_rgba, linewidth=1)
            ax.add_patch(rect)
    ax.set_xticks([]); ax.set_yticks([])
    ax.set_title("bounding boxes")

    _heat(axes[1, 1], fig, "z_depth", np.asarray(z_depth)[b, 0], "autumn")
    _heat(axes[1, 2], fig, "z_presence", zp[b, 0], "winter")
    fig.tight_layout()
    return fig


def attr_stats_figure(z_attr, batch_idx=0, title_prefix=""):
    """z_attr min/mean/max over the attribute axis as (gh, gw) heatmaps —
    the reference's ``plot_objet_attr_latent_representation``
    (debug_tools.py:131-153); also reused for z_attr GRADIENT stats
    (``z_attr_grad_hook``, debug_tools.py:221-243).

    z_attr: (B, A, gh, gw) (NCHW grid, as in the aux pytree)."""
    plt = _require_plt()
    a = np.asarray(z_attr)[batch_idx]  # (A, gh, gw)
    fig, axes = plt.subplots(1, 3, figsize=(7, 2.5))
    _heat(axes[0], fig, f"{title_prefix}Max", a.max(axis=0), "spring")
    _heat(axes[1], fig, f"{title_prefix}Mean", a.mean(axis=0), "spring")
    _heat(axes[2], fig, f"{title_prefix}Min", a.min(axis=0), "spring")
    fig.tight_layout()
    return fig


def decoder_grad_figure(dec_grad, grid_hw, batch_idx=0):
    """Gradient of the loss w.r.t. the decoder's COLOR output channel as a
    full-grid mosaic — the reference's ``decoder_output_grad_hook``
    (debug_tools.py:198-218), reference vmin/vmax +-1e-4.

    dec_grad: (B, N, C, oh, ow) cotangent of the decoded color."""
    plt = _require_plt()
    gh, gw = grid_hw
    g = np.asarray(dec_grad)[batch_idx, :, 0]
    oh, ow = g.shape[-2:]
    fig, ax = plt.subplots(figsize=(10, 10))
    im = ax.imshow(_mosaic(g.reshape(gh, gw, oh, ow)), vmin=-1e-4, vmax=1e-4)
    ax.set_title("gradient of decoder")
    fig.colorbar(im, ax=ax, fraction=0.03, pad=0.04)
    return fig
