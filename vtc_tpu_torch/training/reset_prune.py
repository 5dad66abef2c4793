"""Reset-to-random or prune dictionary elements during training: the
port's own copy of vtc_tpu/training/reset_prune.py:1-219 (host-side
NumPy, no framework).

Capability parity with reference training/sparse_coding.py:522-764, with
three filter types:

  'random'                    pick elements uniformly at random
  'cosine_sim_threshold'      flag one element of every pair whose cosine
                              similarity exceeds a threshold (optionally
                              restricted to within-group pairs; optionally
                              cueing the user for the threshold after
                              showing the similarity distribution)
  'nonuniformity_within_group'  flag groups whose nonzero renormalized
                              codes are nonuniformly distributed on the
                              group hypersphere (variance of great-circle
                              projection-angle histograms, outlier test)

Differences from the reference (deliberate):
  * pure host-side NumPy on explicit inputs; returns the new dictionary
    instead of conditionally mutating in place,
  * works for BOTH fully-connected and convolutional dictionaries (the
    reference raises NotImplementedError for conv, line 761-762);
    cosine similarity for conv kernels uses flattened kernels,
  * pruning REMAPS group indices (the reference leaves stale indices
    behind -- its own "WARNING: doesn't yet work for subspaces" at
    training/sparse_coding.py:490-491),
  * interactivity ('cue_user') goes through an injectable
    ``threshold_picker`` callback (defaults to stdin input()), so
    training jobs stay headless-safe and the flow stays testable.
"""
import numpy as np


def _flatten(dictionary):
  return dictionary.reshape(dictionary.shape[0], -1)


def _random_replacement(dictionary, inds, rng):
  """Unit-scale noise rows with the dictionary's average element norm."""
  flat = _flatten(dictionary)
  avg_norm = np.mean(np.linalg.norm(flat, axis=1))
  noise = rng.standard_normal((len(inds),) + dictionary.shape[1:]).astype(
      dictionary.dtype)
  nf = noise.reshape(len(inds), -1)
  nf *= (avg_norm / np.linalg.norm(nf, axis=1))[:, None]
  out = dictionary.copy()
  out[np.asarray(inds, dtype=int)] = nf.reshape(noise.shape)
  return out


def _prune(dictionary, inds, groups):
  """Remove rows/kernels ``inds``; remap group indices to the new
  numbering (fixing the reference's stale-index defect)."""
  inds = np.unique(np.asarray(inds, dtype=int))
  keep = np.ones(dictionary.shape[0], dtype=bool)
  keep[inds] = False
  new_dictionary = dictionary[keep]
  new_groups = None
  if groups is not None:
    old_to_new = np.cumsum(keep) - 1  # position among survivors
    new_groups = []
    for members in groups:
      new_groups.append(
          [int(old_to_new[m]) for m in members if keep[m]])
  return new_dictionary, new_groups


def _pairwise_cosine(flat):
  norms = np.linalg.norm(flat, axis=1, keepdims=True)
  return (flat @ flat.T) / (norms @ norms.T)


def _one_per_pair(problem_pairs, rng):
  """Pick one member of each offending pair, never flagging an element
  twice (reference lines 637-639, 671-673)."""
  chosen = []
  for pair in problem_pairs:
    if pair[0] not in chosen and pair[1] not in chosen:
      chosen.append(int(pair[rng.choice([0, 1])]))
  return chosen


def _collect_similarities(dictionary, groups, within_group):
  flat = _flatten(dictionary)
  if within_group:
    assert groups is not None
    sims = []
    for members in groups:
      cos = _pairwise_cosine(flat[np.asarray(members, int)])
      iu = np.triu_indices(cos.shape[0], k=1)
      sims.append(cos[iu])
    return np.concatenate(sims) if sims else np.zeros(0)
  cos = _pairwise_cosine(flat)
  iu = np.triu_indices(cos.shape[0], k=1)
  return cos[iu]


def _default_threshold_picker(similarities):
  """Show the similarity distribution, then ask on stdin
  (the reference's matplotlib + input() flow, lines 614-622)."""
  from matplotlib import pyplot as plt
  fig = plt.figure()
  ax = fig.add_subplot(111)
  ax.bar(np.arange(len(similarities)), similarities, width=1.0)
  ax.set_ylabel("Pairwise cosine similarities")
  ax.set_xlabel("Possible distinct pairs")
  plt.show()
  return float(input(
      "Please select a threshold for resetting/pruning dict elements: "))


def group_nonuniformity_scores(codes, groups, num_great_circles, rng):
  """Mean variance of great-circle projection-angle histograms per group.

  For each group: take samples with any nonzero member, renormalize to
  the unit sphere, project onto ``num_great_circles`` random 2-d planes,
  histogram the projection angle into 20 bins, and average the variance
  of the empirical densities (reference lines 699-728).
  """
  scores = []
  for members in groups:
    members = np.asarray(list(members), int)
    sub = codes[:, members]
    nz = sub[np.any(sub != 0, axis=1)]
    if nz.shape[0] == 0:
      scores.append(0.0)
      continue
    renormed = nz / np.linalg.norm(nz, axis=1, keepdims=True)
    variances = []
    for _ in range(num_great_circles):
      v1 = rng.standard_normal(len(members))
      v2 = rng.standard_normal(len(members))
      basis, _ = np.linalg.qr(np.c_[v1 / np.linalg.norm(v1),
                                    v2 / np.linalg.norm(v2)])
      proj = renormed @ basis
      angle = np.angle(proj[:, 0] + 1j * proj[:, 1])
      counts, _ = np.histogram(angle, np.linspace(-np.pi, np.pi, 21))
      density = counts / max(np.sum(counts), 1)
      variances.append(np.var(density))
    scores.append(float(np.mean(variances)))
  return np.asarray(scores)


def reset_or_prune_dict_elements(dictionary, codes, filter_type,
                                 filter_params, action, rng=None,
                                 threshold_picker=None):
  """Select dictionary elements via a filter and reset or prune them.

  Args:
    dictionary: (s, n) or (s, c, kh, kw) NumPy array (not mutated).
    codes: (b, s) or (b, s, sh, sw) codes for a held-out set (used by the
      'nonuniformity_within_group' filter).
    filter_type: 'random' | 'cosine_sim_threshold' |
      'nonuniformity_within_group'.
    filter_params: dict, see module docstring / reference docstring.
      Recognized keys: 'group_assignments', 'num_to_modify', 'cue_user',
      'only_sim_within_group', 'threshold', 'num_gc_in_average'.
    action: 'reset' | 'prune'.
    rng: np.random.Generator (fresh default_rng() if None).
    threshold_picker: callable(similarities)->float used when
      cue_user=True; defaults to the interactive stdin flow.

  Returns:
    (new_dictionary, affected_indices, new_group_assignments)
    new_group_assignments is None unless groups were provided; after a
    prune it reflects the remapped indices.
  """
  assert action in ("reset", "prune")
  dictionary = np.asarray(dictionary)
  rng = rng if rng is not None else np.random.default_rng()
  groups = filter_params.get("group_assignments")

  if filter_type == "random":
    modify = rng.choice(np.arange(dictionary.shape[0]),
                        size=filter_params["num_to_modify"],
                        replace=False)
  elif filter_type == "cosine_sim_threshold":
    within = bool(filter_params.get("only_sim_within_group", False))
    if filter_params.get("cue_user", False):
      sims = _collect_similarities(dictionary, groups, within)
      picker = threshold_picker or _default_threshold_picker
      threshold = float(picker(sims))
    else:
      threshold = float(filter_params["threshold"])
    flat = _flatten(dictionary)
    modify = []
    if within:
      assert groups is not None
      for members in groups:
        members = np.asarray(list(members), int)
        cos = _pairwise_cosine(flat[members])
        pairs = np.argwhere(np.abs(np.triu(cos, k=1)) > threshold)
        local = _one_per_pair(pairs, rng)
        modify.extend(int(members[i]) for i in local)
    else:
      cos = _pairwise_cosine(flat)
      pairs = np.argwhere(np.triu(cos, k=1) > threshold)
      modify = _one_per_pair(pairs, rng)
    modify = np.asarray(modify, dtype=int)
  elif filter_type == "nonuniformity_within_group":
    assert groups is not None
    codes2d = np.asarray(codes).reshape(np.shape(codes)[0], -1)
    scores = group_nonuniformity_scores(
        codes2d, groups, filter_params["num_gc_in_average"], rng)
    # outlier test: > 1 std from the mean AND above an absolute floor
    # (reference lines 729-737)
    flagged = np.nonzero(
        (np.abs(scores - scores.mean()) > scores.std()) &
        (np.abs(scores) > 0.002))[0]
    modify = np.asarray(
        sorted({m for g in flagged for m in groups[g]}), dtype=int)
  else:
    raise KeyError("Unrecognized filter type: " + filter_type)

  if len(modify) == 0:
    return dictionary, modify, groups
  if action == "reset":
    return _random_replacement(dictionary, modify, rng), modify, groups
  new_dictionary, new_groups = _prune(dictionary, modify, groups)
  return new_dictionary, modify, new_groups
