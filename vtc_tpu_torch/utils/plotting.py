"""Dictionary figures for the trainers' visualization schedule: the
port's own copy of ``display_dictionary`` and what it calls, from
vtc_tpu/utils/plotting.py:84-294 (host-side NumPy and matplotlib).

matplotlib uses the Agg backend unless one is already selected, so these
work in headless training jobs (TensorBoard image logging).
"""
import math

import numpy as np

import matplotlib
if matplotlib.get_backend().lower() not in ("agg",):  # headless-safe
  try:
    matplotlib.use("Agg")
  except Exception:  # pragma: no cover - backend already in use
    pass
from matplotlib import pyplot as plt


def standardize_for_imshow(image):
  """Map an arbitrary-range image into [0, 1] with a transparent rule.

  Nonnegative images are scaled so max -> 1; nonpositive so min -> 0 (after
  shifting); sign-straddling images map 0 -> 0.5 symmetrically around the
  largest absolute value.  Returns (standardized_image, raw_val_mapping)
  where raw_val_mapping gives the raw values displayed as [black, mid,
  white].
  """
  image = np.asarray(image)
  max_val = float(np.max(image))
  min_val = float(np.min(image))
  if max_val == min_val:
    std_img = np.full(image.shape, 0.5)
    if max_val > 0:
      mapping = [0.0, max_val, 2 * max_val]
    elif max_val < 0:
      mapping = [2 * max_val, max_val, 0.0]
    else:
      mapping = [-1.0, 0.0, 1.0]
    return std_img, mapping
  if min_val >= 0:
    return image / max_val, [0.0, 0.5 * max_val, max_val]
  if max_val <= 0:
    return image / (-min_val) + 1.0, [min_val, 0.5 * min_val, 0.0]
  bound = max(abs(min_val), abs(max_val))
  std_img = image / (2 * bound) + 0.5
  if abs(max_val) >= abs(min_val):
    mapping = [-max_val, 0.0, max_val]
  else:
    mapping = [min_val, 0.0, -min_val]
  return std_img, mapping


def _elements_as_patches(dictionary, reshaping=None):
  """(s, ph, pw[, c]) array of displayable patches from either dictionary
  format ((s, n) fully-connected or (s, c, kh, kw) convolutional)."""
  dictionary = np.asarray(dictionary)
  if dictionary.ndim == 2:
    s, n = dictionary.shape
    if reshaping is None:
      side = int(math.sqrt(n))
      if side * side == n:
        reshaping = (side, side)
      else:
        reshaping = (1, n)  # 1-d data: show as a row
    return dictionary.reshape((s,) + tuple(reshaping))
  # convolutional (s, c, kh, kw) -> (s, kh, kw) or (s, kh, kw, c)
  s, c, kh, kw = dictionary.shape
  if c == 1:
    return dictionary[:, 0]
  return np.moveaxis(dictionary, 1, 3)


def _tile_grid(patches, grid_hw, border=1, fill=0.35):
  """Compose (k, ph, pw[,c]) patches into one bordered mosaic image."""
  k = patches.shape[0]
  gh, gw = grid_hw
  ph, pw = patches.shape[1], patches.shape[2]
  color = patches.ndim == 4
  shape = (gh * (ph + border) + border, gw * (pw + border) + border) + (
      (patches.shape[3],) if color else ())
  canvas = np.full(shape, fill, dtype=np.float32)
  for idx in range(min(k, gh * gw)):
    r, c = divmod(idx, gw)
    y = border + r * (ph + border)
    x = border + c * (pw + border)
    canvas[y:y + ph, x:x + pw] = patches[idx]
  return canvas


_MAX_TILES_PER_FIG = 400


def get_dictionary_tile_imgs(dictionary, indv_renorm=False,
                             reshape_to_these_dims=None, highlights=None,
                             max_tiles_per_fig=_MAX_TILES_PER_FIG,
                             one_d_tile=False):
  """Tile dictionary elements into mosaic images (multiple if s is large).

  ``one_d_tile`` lays the elements out in a single horizontal strip
  (at most 80 per image) instead of a square grid — the reference's
  flat-subtile layout (plotting.py:217,272-291).

  Returns (tile_images, raw_val_mapping, label_coords) where label_coords
  gives, per figure, (index_label, y_pixel, x_pixel) tuples for optional
  index annotation.
  """
  if one_d_tile:
    max_tiles_per_fig = min(max_tiles_per_fig, 80)
  patches = _elements_as_patches(dictionary, reshape_to_these_dims)
  order = np.arange(patches.shape[0])
  weights = None
  if highlights is not None:
    weights = np.asarray(highlights["weights"])
    if highlights.get("reorder", False):
      order = np.argsort(weights)[::-1]
      patches = patches[order]
      weights = weights[order]

  if indv_renorm:
    shown = np.stack([standardize_for_imshow(p)[0] for p in patches])
    mapping = [0.0, 0.5, 1.0]
  else:
    shown, mapping = standardize_for_imshow(patches)

  if weights is not None:
    shown = _colorize_by_weight(shown, weights,
                                highlights.get("color_range", (-1.0, 1.0)))

  imgs, labels = [], []
  for start in range(0, shown.shape[0], max_tiles_per_fig):
    chunk = shown[start:start + max_tiles_per_fig]
    if one_d_tile:
      gw, gh = chunk.shape[0], 1
    else:
      gw = int(math.ceil(math.sqrt(chunk.shape[0])))
      gh = int(math.ceil(chunk.shape[0] / gw))
    imgs.append(_tile_grid(chunk, (gh, gw)))
    ph, pw = chunk.shape[1], chunk.shape[2]
    labels.append([
        (str(order[start + i]),
         1 + (i // gw) * (ph + 1), 1 + (i % gw) * (pw + 1))
        for i in range(chunk.shape[0])])
  return imgs, mapping, labels


def _colorize_by_weight(gray_tiles, weights, color_range):
  """Tint grayscale tiles blue-to-red by per-element scalar weights."""
  lo, hi = color_range
  t = np.clip((weights - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
  cmap = plt.get_cmap("RdBu_r")
  if gray_tiles.ndim == 3:
    gray_tiles = np.repeat(gray_tiles[..., None], 3, axis=3)
  tinted = gray_tiles.copy()
  for idx in range(gray_tiles.shape[0]):
    tint = np.asarray(cmap(t[idx]))[:3]
    tinted[idx] = 0.7 * gray_tiles[idx] + 0.3 * tint[None, None, :]
  return tinted


def get_dictionary_tile_imgs_arr_by_group(dictionary, groups,
                                          indv_renorm=False,
                                          reshape_to_these_dims=None,
                                          highlights=None):
  """Group-aware tiling: each group occupies one row (groups are small)."""
  patches = _elements_as_patches(dictionary, reshape_to_these_dims)
  if indv_renorm:
    shown = np.stack([standardize_for_imshow(p)[0] for p in patches])
  else:
    shown, _ = standardize_for_imshow(patches)
  max_gs = max(len(g) for g in groups)
  rows = []
  for members in groups:
    sel = shown[np.asarray(list(members), dtype=int)]
    if sel.shape[0] < max_gs:  # pad the row
      pad = np.full((max_gs - sel.shape[0],) + sel.shape[1:], 0.35,
                    sel.dtype)
      sel = np.concatenate([sel, pad], axis=0)
    rows.append(_tile_grid(sel, (1, max_gs)))
  # stack group-rows vertically into figures of at most 50 rows
  imgs = []
  for start in range(0, len(rows), 50):
    imgs.append(np.concatenate(rows[start:start + 50], axis=0))
  return imgs


def display_dictionary(dictionary, renormalize=False, reshaping=None,
                       groupings=None, label_inds=False, highlighting=None,
                       plot_title=""):
  """Render the dictionary as one or more matplotlib figures.

  Mirrors the reference API (utils/plotting.py:126-212): renormalize for
  per-element color scales, reshaping for fully-connected elements,
  groupings for one-group-per-row layout, label_inds for index overlays,
  highlighting={'weights', 'color_range', 'reorder'} for scalar tinting.
  Returns a list of figures.
  """
  if groupings is None:
    tiles, mapping, labels = get_dictionary_tile_imgs(
        dictionary, indv_renorm=renormalize,
        reshape_to_these_dims=reshaping, highlights=highlighting)
  else:
    tiles = get_dictionary_tile_imgs_arr_by_group(
        dictionary, groupings, indv_renorm=renormalize,
        reshape_to_these_dims=reshaping, highlights=highlighting)
    mapping, labels = [0.0, 0.5, 1.0], None

  figs = []
  for fig_idx, tile_img in enumerate(tiles):
    fig = plt.figure(figsize=(10, 10))
    ax = plt.axes((0.075, 0.075, 0.85, 0.85))
    fig.suptitle("{}, fig {} of {}".format(plot_title, fig_idx + 1,
                                           len(tiles)), fontsize=16)
    ax.imshow(tile_img, cmap="gray", vmin=0.0, vmax=1.0,
              interpolation="none")
    if label_inds and labels is not None:
      for text, y, x in labels[fig_idx]:
        ax.text(x, y, text, fontsize=6, va="top", ha="left", color="w")
    ax.axis("off")
    if not renormalize and groupings is None:
      cbar_ax = plt.axes((0.945, 0.4, 0.01, 0.2))
      cbar_ax.imshow(np.linspace(1.0, 0.0, 256)[:, None], cmap="gray",
                     aspect="auto")
      cbar_ax.yaxis.tick_right()
      cbar_ax.xaxis.set_ticks([])
      cbar_ax.yaxis.set_ticks([0, 128, 255])
      cbar_ax.yaxis.set_ticklabels(
          ["{:.2f}".format(v) for v in mapping[::-1]], fontsize=8)
    figs.append(fig)
  return figs
