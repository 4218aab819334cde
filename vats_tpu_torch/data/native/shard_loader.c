/* Native batch assembly for the token-shard data loader.
 *
 * The port's copy of the JAX package's C loader (no framework code): batch
 * assembly -- gather, pad, shift-for-labels, mask -- runs here in C instead
 * of a per-row Python loop, off the interpreter lock.  Compiled at first use
 * by vats_tpu_torch/data/shard_dataset.py and bound with ctypes.
 *
 * Layout contract (see vats_tpu_torch/data/shard_dataset.py):
 *   tokens:  int32[total_tokens]        concatenated documents
 *   offsets: int64[num_docs + 1]        doc d = tokens[offsets[d]:offsets[d+1]]
 *
 * pack_batch semantics mirror TextDataset.__getitem__:
 *   input_ids[r, :len] = doc tokens (truncated to seq_len), pad elsewhere
 *   labels[r, i] = input_ids[r, i+1] for i < len-1, ignore_index elsewhere
 *   mask[r, i] = 1 for i < len
 */

#include <stdint.h>
#include <stddef.h>

void pack_batch(const int32_t *tokens,
                const int64_t *offsets,
                const int64_t *doc_indices,
                int64_t batch_size,
                int64_t seq_len,
                int32_t pad_id,
                int32_t ignore_index,
                int32_t *out_ids,
                int32_t *out_labels,
                uint8_t *out_mask) {
  for (int64_t r = 0; r < batch_size; ++r) {
    const int64_t d = doc_indices[r];
    const int64_t start = offsets[d];
    int64_t len = offsets[d + 1] - start;
    if (len > seq_len) len = seq_len;

    int32_t *ids = out_ids + r * seq_len;
    int32_t *labels = out_labels + r * seq_len;
    uint8_t *mask = out_mask + r * seq_len;

    for (int64_t i = 0; i < len; ++i) {
      ids[i] = tokens[start + i];
      mask[i] = 1;
    }
    for (int64_t i = len; i < seq_len; ++i) {
      ids[i] = pad_id;
      mask[i] = 0;
    }
    for (int64_t i = 0; i + 1 < len; ++i) {
      labels[i] = ids[i + 1];
    }
    for (int64_t i = (len > 0 ? len - 1 : 0); i < seq_len; ++i) {
      labels[i] = ignore_index;
    }
  }
}

/* Greedy sequence packing: fill each output row with as many whole documents
 * as fit (segment ids mark document boundaries for segment-masked attention).
 * Returns the number of documents consumed. */
int64_t pack_sequences(const int32_t *tokens,
                       const int64_t *offsets,
                       int64_t num_docs,
                       int64_t start_doc,
                       int64_t batch_size,
                       int64_t seq_len,
                       int32_t pad_id,
                       int32_t ignore_index,
                       int32_t *out_ids,
                       int32_t *out_labels,
                       int32_t *out_segments,
                       uint8_t *out_mask) {
  int64_t d = start_doc;
  for (int64_t r = 0; r < batch_size; ++r) {
    int32_t *ids = out_ids + r * seq_len;
    int32_t *labels = out_labels + r * seq_len;
    int32_t *segs = out_segments + r * seq_len;
    uint8_t *mask = out_mask + r * seq_len;

    int64_t pos = 0;
    int32_t seg = 1;
    while (d < num_docs) {
      const int64_t start = offsets[d];
      const int64_t len = offsets[d + 1] - start;
      if (len > seq_len) { /* oversized doc: truncate into a fresh row */
        if (pos != 0) break;
        for (int64_t i = 0; i < seq_len; ++i) {
          ids[i] = tokens[start + i];
          segs[i] = seg;
          mask[i] = 1;
        }
        for (int64_t i = 0; i + 1 < seq_len; ++i) labels[i] = ids[i + 1];
        labels[seq_len - 1] = ignore_index;
        pos = seq_len;
        ++d;
        break;
      }
      if (pos + len > seq_len) break;
      for (int64_t i = 0; i < len; ++i) {
        ids[pos + i] = tokens[start + i];
        segs[pos + i] = seg;
        mask[pos + i] = 1;
      }
      for (int64_t i = 0; i + 1 < len; ++i) labels[pos + i] = ids[pos + i + 1];
      labels[pos + len - 1] = ignore_index; /* no cross-document labels */
      pos += len;
      ++seg;
      ++d;
    }
    for (int64_t i = pos; i < seq_len; ++i) {
      ids[i] = pad_id;
      labels[i] = ignore_index;
      segs[i] = 0;
      mask[i] = 0;
    }
  }
  return d - start_doc;
}
