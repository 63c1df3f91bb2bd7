"""Streaming data pipeline (counterpart of ``chunkformer_tpu/data/pipeline.py``;
reference chunkformer/dataset/dataset.py:26-161, dataset/datapipes.py:33-461).

A chain of Python generators: source (raw list / tar shards) -> parse ->
decode -> tokenize -> filter -> resample -> augment -> fbank -> spec_aug ->
shuffle -> sort -> batch (static / bucket / dynamic) -> padded collate.

- Each process reads its own shard (``shard`` by rank); CV data is read
  whole by every process, as the reference's CV path (datapipes.py:286-296).
  ``dataset_conf.epoch_steps`` fixes the step count of an epoch on every
  process (``fixed_epoch_steps``), and the Executor pads ragged batch axes,
  so no join barrier is needed.
- Collation pads to shape buckets; ``batch_conf.static_shapes`` pads every
  batch to one fixed [B, T_max, F] / [B, U_max] shape.
- ``prefetch_buffer`` runs the pipeline in a background thread
  (reference: PrefetchDataPipe datapipes.py:208-250).

Random draws use ``np.random.default_rng(seed + epoch)`` and
``random.Random(seed + epoch)`` in the JAX package's order, so the batches
of one seed are the JAX package's.
"""

from __future__ import annotations

import json
import queue
import random
import tarfile
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from . import processor


def text_line_source(path: str) -> Iterator[Dict]:
    """list file: json per line or `key\\twav\\ttxt` (datapipes.py:338-352)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                yield json.loads(line)
            else:
                parts = line.split("\t")
                if len(parts) >= 3:
                    yield {"key": parts[0], "wav": parts[1], "txt": parts[2]}
                elif len(parts) == 2:
                    yield {"key": parts[0], "wav": parts[1]}


def tar_shard_source(shard_list: Iterable[str]) -> Iterator[Dict]:
    """WeNet tar-shard reader (datapipes.py:355-461): entries `key.wav` +
    `key.txt` grouped by stem."""
    for shard in shard_list:
        with tarfile.open(shard, "r|*") as tar:
            current: Dict[str, Any] = {}
            for member in tar:
                if not member.isfile():
                    continue
                stem, _, ext = member.name.rpartition(".")
                data = tar.extractfile(member).read()
                if current.get("key") not in (None, stem):
                    if "wav" in current:
                        yield current
                    current = {}
                current["key"] = stem
                if ext in ("wav", "flac", "mp3"):
                    current["wav"] = data
                elif ext == "txt":
                    current["txt"] = data.decode("utf-8").strip()
            if "wav" in current:
                yield current


def shard(source: Iterator[Dict], num_shards: int, shard_id: int,
          full_data: bool = False) -> Iterator[Dict]:
    """Rank sharding (datapipes.py:272-296); full_data replicates (CV mode)."""
    if full_data or num_shards <= 1:
        yield from source
        return
    for i, sample in enumerate(source):
        if i % num_shards == shard_id:
            yield sample


def mapper_ignore_error(source: Iterator[Dict], fn: Callable[[Dict], Dict],
                        log_error: bool = True) -> Iterator[Dict]:
    """Per-sample error swallowing (datapipes.py:33-61)."""
    for sample in source:
        try:
            yield fn(sample)
        except Exception as e:  # noqa: BLE001
            if log_error:
                import logging

                logging.warning("data error for %s: %s", sample.get("key"), e)


def shuffle(source: Iterator[Dict], buffer_size: int = 1000,
            rng: Optional[random.Random] = None) -> Iterator[Dict]:
    """(datapipes sort/shuffle buffers)"""
    rng = rng or random.Random(0)
    buf: List[Dict] = []
    for sample in source:
        buf.append(sample)
        if len(buf) >= buffer_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort_by_length(source: Iterator[Dict], sort_size: int = 500) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in source:
        buf.append(sample)
        if len(buf) >= sort_size:
            buf.sort(key=lambda s: s["feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda s: s["feat"].shape[0])
    yield from buf


def static_batch(source: Iterator[Dict], batch_size: int,
                 drop_last: bool = False) -> Iterator[List[Dict]]:
    buf: List[Dict] = []
    for sample in source:
        buf.append(sample)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf


def dynamic_batch(source: Iterator[Dict],
                  max_frames_in_batch: int = 12000) -> Iterator[List[Dict]]:
    """Token-budget batching (processor.py:578-594 + datapipes.py:179-205)."""
    window = processor.DynamicBatchWindow(max_frames_in_batch)
    buf: List[Dict] = []
    for sample in source:
        if buf and window(sample, len(buf)):
            yield buf
            buf = []
        buf.append(sample)
    if buf:
        yield buf


def bucket_batch(source: Iterator[Dict], bucket_boundaries: List[int],
                 bucket_batch_sizes: List[int]) -> Iterator[List[Dict]]:
    """Length-bucketed batching (reference: datapipes.py:64-146
    BucketBySequenceLengthDataPipe).

    Sample with feat length t goes to the first bucket with boundary > t;
    each bucket has its own batch size, so short utterances pack into large
    batches and long ones into small — near-constant frames per batch with
    far less padding than static batching. Leftovers flush at end of stream.
    """
    assert len(bucket_batch_sizes) == len(bucket_boundaries) + 1, \
        (len(bucket_boundaries), len(bucket_batch_sizes))
    boundaries = list(bucket_boundaries)
    buckets: List[List[Dict]] = [[] for _ in bucket_batch_sizes]

    def bucket_id(n: int) -> int:
        for i, b in enumerate(boundaries):
            if n < b:
                return i
        return len(boundaries)

    for sample in source:
        i = bucket_id(sample["feat"].shape[0])
        buckets[i].append(sample)
        if len(buckets[i]) >= bucket_batch_sizes[i]:
            yield buckets[i]
            buckets[i] = []
    for buf in buckets:
        if buf:
            yield buf


def repeat(make_source: Callable[[], Iterator], count: int = -1) -> Iterator:
    """Re-instantiate and replay a source `count` times (-1 = forever)
    (reference: datapipes.py:252-269 RepeatDatapipe)."""
    n = 0
    while count < 0 or n < count:
        yield from make_source()
        n += 1


def interleave(sources: List[Iterator], weights: Optional[List[float]] = None,
               rng: Optional[random.Random] = None) -> Iterator:
    """Weighted random interleave of multiple sources
    (reference: datapipes.py:299-336 InterlaveDataPipe). Exhausted sources
    drop out; ends when all are exhausted."""
    rng = rng or random.Random(0)
    live = list(sources)
    w = list(weights) if weights else [1.0] * len(live)
    while live:
        i = rng.choices(range(len(live)), weights=w, k=1)[0]
        try:
            yield next(live[i])
        except StopIteration:
            del live[i]
            del w[i]


def group_by_window(source: Iterator[Dict], key_fn: Callable[[Dict], int],
                    window_size: int) -> Iterator[List[Dict]]:
    """Group consecutive samples by a key into windows of `window_size`
    (reference: datapipes.py:102-146 GroupByWindowDataPipe)."""
    groups: Dict[int, List[Dict]] = {}
    for sample in source:
        k = key_fn(sample)
        groups.setdefault(k, []).append(sample)
        if len(groups[k]) >= window_size:
            yield groups.pop(k)
    for buf in groups.values():
        if buf:
            yield buf


def prefetch(source: Iterator, buffer_size: int = 8) -> Iterator:
    """Background-thread prefetch (reference: datapipes.py:208-250).

    Runs the upstream pipeline in a daemon thread feeding a bounded queue, so
    host-side decode/fbank/augment overlaps with the card's steps.
    Exceptions re-raise in the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=max(buffer_size, 1))
    _END, _ERR = object(), object()

    def producer():
        try:
            for item in source:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put((_ERR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        yield item


def fixed_epoch_steps(batches: Iterator[Dict], n_steps: int) -> Iterator[Dict]:
    """Emit exactly `n_steps` batches per epoch on every host.

    Deterministic replacement for the reference's uneven-data join barrier
    (wenet_join gloo monitored_barrier, utils/train_utils.py:636-664): if a
    process's stream runs short, the final batch is replayed; if long, the
    tail is dropped. Every process therefore runs the same number of
    collective steps.
    """
    last = None
    emitted = 0
    for batch in batches:
        if emitted >= n_steps:
            return
        yield batch
        last = batch
        emitted += 1
    if last is None and n_steps > 0:
        # an empty shard cannot honor the fixed step count: the other
        # processes would enter collectives this one never joins
        raise RuntimeError(
            "fixed_epoch_steps: data stream yielded no batches but "
            f"epoch_steps={n_steps}; this host's shard is empty — reduce "
            "epoch_steps, rebalance shards, or drop dataset_conf.epoch_steps")
    while emitted < n_steps and last is not None:
        yield last
        emitted += 1


class Dataset:
    """Config-driven pipeline (reference dataset.py:26-161)."""

    def __init__(self, data_type: str, data_list: str, tokenizer=None,
                 conf: Optional[Dict] = None, partition: bool = True,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                 is_classification: bool = False):
        self.data_type = data_type
        self.data_list = data_list
        self.tokenizer = tokenizer
        self.conf = conf or {}
        self.partition = partition
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.epoch = 0
        self.is_classification = is_classification

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        conf = self.conf
        rng = np.random.default_rng(self.seed + self.epoch)
        pyrng = random.Random(self.seed + self.epoch)

        if self.data_type == "shard":
            shards = [s["wav"] if isinstance(s, dict) else s
                      for s in text_line_source(self.data_list)]
            if self.partition:
                shards = shards[self.shard_id::self.num_shards] or shards[:1]
            src: Iterator[Dict] = tar_shard_source(shards)
        else:
            src = shard(text_line_source(self.data_list), self.num_shards,
                        self.shard_id, full_data=not self.partition)

        sr = conf.get("resample_conf", {}).get("resample_rate", 16000)
        src = mapper_ignore_error(src, lambda s: processor.decode_wav(s, sr))
        if self.tokenizer is not None:
            src = mapper_ignore_error(src, lambda s: processor.tokenize(s, self.tokenizer))
        if self.is_classification:
            src = mapper_ignore_error(src, _extract_class_labels)
        if conf.get("speed_perturb", False):
            src = mapper_ignore_error(src, lambda s: processor.do_speed_perturb(s, rng=rng))

        feats_type = conf.get("feats_type", "fbank")
        if feats_type == "log_mel_spectrogram":
            lm = conf.get("log_mel_spectrogram_conf", {})

            def _logmel(s):
                s["feat"] = processor.compute_log_mel_spectrogram_numpy(
                    s["waveform"], lm.get("n_fft", 400), lm.get("hop_length", 160),
                    lm.get("num_mel_bins", 80), s["sample_rate"],
                    lm.get("padding", 0))
                return s

            src = mapper_ignore_error(src, _logmel)
        elif feats_type == "mfcc":
            mc = conf.get("mfcc_conf", {})

            def _mfcc(s):
                s["feat"] = processor.compute_mfcc_numpy(
                    s["waveform"], mc.get("num_mel_bins", 23),
                    mc.get("num_ceps", 13), mc.get("frame_length", 25),
                    mc.get("frame_shift", 10), mc.get("dither", 0.0),
                    s["sample_rate"], rng=rng)
                return s

            src = mapper_ignore_error(src, _mfcc)
        else:
            fb = conf.get("fbank_conf", {})
            src = mapper_ignore_error(src, lambda s: processor.compute_fbank(
                s, fb.get("num_mel_bins", 80), fb.get("frame_length", 25),
                fb.get("frame_shift", 10), fb.get("dither", 0.0), rng=rng))

        fc = conf.get("filter_conf", {})
        src = (s for s in src if processor.filter_sample(
            s, fc.get("max_length", 40960), fc.get("min_length", 0),
            fc.get("token_max_length", 400), fc.get("token_min_length", 1)))

        if conf.get("spec_aug", False):
            sa = conf.get("spec_aug_conf", {})
            src = mapper_ignore_error(src, lambda s: processor.spec_aug(
                s, sa.get("num_t_mask", 2), sa.get("num_f_mask", 2),
                sa.get("max_t", 50), sa.get("max_f", 10), rng=rng,
                fill=sa.get("fill", "zero")))
        if conf.get("spec_sub", False):
            ss = conf.get("spec_sub_conf", {})
            src = mapper_ignore_error(src, lambda s: processor.spec_sub(
                s, ss.get("max_t", 20), ss.get("num_t_sub", 3), rng=rng))
        if conf.get("spec_trim", False):
            st = conf.get("spec_trim_conf", {})
            src = mapper_ignore_error(src, lambda s: processor.spec_trim(
                s, st.get("max_t", 20), rng=rng))

        if conf.get("shuffle", True):
            src = shuffle(src, conf.get("shuffle_conf", {}).get("shuffle_size", 1000),
                          pyrng)
        if conf.get("sort", True):
            src = sort_by_length(src, conf.get("sort_conf", {}).get("sort_size", 500))

        bc = conf.get("batch_conf", {})
        btype = bc.get("batch_type", "static")
        if btype == "dynamic":
            batches = dynamic_batch(src, bc.get("max_frames_in_batch", 12000))
        elif btype == "bucket":
            batches = bucket_batch(src, bc.get("bucket_boundaries", [500, 1000, 2000]),
                                   bc.get("bucket_batch_sizes", [64, 32, 16, 8]))
        else:
            batches = static_batch(src, bc.get("batch_size", 16),
                                   bc.get("drop_last", False))

        pad_to_time = pad_to_label = pad_to_batch = None
        if bc.get("static_shapes", False):
            # one shape for every batch
            pad_to_time = bc.get("pad_to_time", fc.get("max_length", 40960))
            pad_to_label = bc.get("pad_to_label", fc.get("token_max_length", 400))
            pad_to_batch = bc.get("batch_size", 16) if btype == "static" else None

        collated = (
            processor.padding(b, is_classification=self.is_classification,
                              pad_to_time=pad_to_time, pad_to_label=pad_to_label,
                              pad_to_batch=pad_to_batch)
            for b in batches)

        epoch_steps = conf.get("epoch_steps")
        if epoch_steps:
            collated = fixed_epoch_steps(collated, int(epoch_steps))
        n_prefetch = conf.get("prefetch_buffer", 0)
        if n_prefetch:
            collated = prefetch(collated, int(n_prefetch))
        yield from collated


def _extract_class_labels(sample: Dict) -> Dict:
    """Classification label columns: sample['tasks'] json or per-task keys."""
    labels = {}
    if "class_labels" in sample:
        return sample
    for k, v in list(sample.items()):
        if k.startswith("label_"):
            labels[k[len("label_"):]] = int(v)
    sample["class_labels"] = labels
    return sample
