"""``BatchIterator``: counterpart of vtc_tpu/data/dataset_generation.py:35-63.

A copy, as every host helper of the port is: the port imports nothing
of vtc_tpu (``SparseCoder.fit`` runs it, and the card's machine has no
jax).  It draws the same shuffle order as vtc_tpu's from the same seed
(numpy ``default_rng``), which tests/test_torch_port_trainer.py checks.
"""
import numpy as np


class BatchIterator:
  """Re-iterable shuffling batch iterator over a stacked sample array.

  Yields (b, ...) numpy batches; reshuffles each epoch when shuffle=True.
  """

  def __init__(self, samples, batch_size, shuffle=True, drop_last=True,
               seed=0):
    self.samples = np.asarray(samples)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self._rng = np.random.default_rng(seed)

  def __iter__(self):
    order = np.arange(self.samples.shape[0])
    if self.shuffle:
      self._rng.shuffle(order)
    stop = (self.samples.shape[0] // self.batch_size * self.batch_size
            if self.drop_last else self.samples.shape[0])
    for start in range(0, stop, self.batch_size):
      yield self.samples[order[start:start + self.batch_size]]

  def __len__(self):
    if self.drop_last:
      return self.samples.shape[0] // self.batch_size
    return -(-self.samples.shape[0] // self.batch_size)
