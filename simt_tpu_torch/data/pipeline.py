"""Host input pipeline: decode -> resize -> augment -> batch -> card (counterpart of
``simt_tpu/data/pipeline.py``).

One loader serves training and evaluation, as in the JAX package. Semantics kept exactly:
  - PIL bicubic resize for images, nearest for labels (cityscapes_dataset.py:105-106),
    or the native library (``_native_preproc``), which is bit-identical to PIL at the
    production sizes;
  - an optional horizontal mirror with p = 0.5 (:111-114), from a seeded generator whose
    seed is drawn on the main thread, so threads, processes and the JAX package's
    loader yield the same batches for one seed;
  - RGB -> BGR and the mean subtraction (:117-118), the latter on the device;
  - the GTA5 id -> train id remap with 255 fill (gta5_dataset.py:60-63);
  - epoch-free iteration: the index list is reshuffled each epoch and repeated.

Wire format: the loader ships **uint8** BGR NHWC images and uint8 labels; the float
cast with the mean subtraction (``normalize_image``) and the int32 cast of the labels
(``normalize_label``) happen on the device, at the top of every step and eval forward.
PIL's resize returns uint8 before the reference converts to float
(cityscapes_dataset.py:100,117-118), so host and device together compute the
reference's values, with a quarter of float32's bytes to the card.

Process workers import this module, so it imports neither ``torch`` nor anything that
touches CUDA when it is imported: ``torch`` is imported inside the functions that run
on the main process.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import lists

# Module switch for the native library; ``build_loader`` sets it from
# ``DataConfig.use_native_preproc`` and ``Loader`` carries it into process workers.
USE_NATIVE = True


def _native():
    """The native preprocessing module when ``USE_NATIVE`` is set, else None (PIL).

    Bicubic is bit-identical to Pillow at every size; nearest is bit-identical at the
    production label geometries (2048x1024 -> 1024x512, GTA5 1914x1052 -> the crop) and
    at the tested downscales (Pillow's mixed fixed/float internals can differ on
    integer-tie columns at other ratios). A library that fails to build or load raises:
    PIL runs only when the switch says so.
    """
    if not USE_NATIVE:
        return None
    from . import _native_preproc

    _native_preproc.load()
    return _native_preproc


def _open_image(path: str, mode: Optional[str] = "RGB"):
    from PIL import Image

    img = Image.open(path)
    return img.convert(mode) if mode else img


def load_image_bgr(path: str, crop_wh: Tuple[int, int], mean_bgr: Sequence[float],
                   mirror: bool = False) -> np.ndarray:
    """Decode + bicubic resize to (w, h) + [mirror] + BGR + mean-sub, HWC float32
    (cityscapes_dataset.py:100,105,108,111-118)."""
    from PIL import Image

    native = _native()
    if native is not None:
        rgb = np.asarray(_open_image(path), np.uint8)
        return native.preprocess_image(rgb, crop_wh[1], crop_wh[0], mean_bgr, mirror)
    arr = np.asarray(_open_image(path).resize(crop_wh, Image.BICUBIC), np.float32)
    if mirror:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr[:, :, ::-1] - np.asarray(mean_bgr, np.float32))


def load_image_bgr_u8(path: str, crop_wh: Tuple[int, int],
                      mirror: bool = False) -> np.ndarray:
    """Decode + bicubic resize to (w, h) + [mirror] + BGR, HWC **uint8**: the wire
    format. The values are exactly PIL's resize output (cityscapes_dataset.py:100,105)."""
    from PIL import Image

    native = _native()
    if native is not None:
        rgb = np.asarray(_open_image(path), np.uint8)
        # The native resampler is Pillow-exact, so with a zero mean its float values
        # are whole numbers; rint, not truncation, so that a value a float ulp below
        # an integer cannot go off by one.
        f = native.preprocess_image(rgb, crop_wh[1], crop_wh[0], (0.0, 0.0, 0.0), mirror)
        return np.rint(f).astype(np.uint8)
    arr = np.asarray(_open_image(path).resize(crop_wh, Image.BICUBIC), np.uint8)
    if mirror:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr[:, :, ::-1])


@functools.lru_cache(maxsize=None)
def _mean_on(device, mean_bgr: Tuple[float, ...]):
    """The mean as a float32 tensor on ``device``, made once: a copy from pageable host
    memory to the card waits for every operation queued before it, which would stall
    the host at the top of every step. Made outside inference mode (the eval forward
    runs in it), so that training can use it too."""
    import torch

    with torch.inference_mode(False):
        return torch.tensor(mean_bgr, dtype=torch.float32).to(device)


def normalize_image(image, mean_bgr: Sequence[float]):
    """Device half of the pipeline: uint8 BGR -> float32 mean-subtracted
    (cityscapes_dataset.py:117-118). float32 inputs pass through unchanged."""
    import torch

    if image.dtype == torch.uint8:
        return image.to(torch.float32) - _mean_on(image.device, tuple(mean_bgr))
    return image


def normalize_label(label):
    """uint8 wire labels -> int32 (ids are <= 255, the 255 ignore id included); other
    dtypes pass through unchanged."""
    import torch

    return label.to(torch.int32) if label.dtype == torch.uint8 else label


def load_label(path: str, crop_wh: Tuple[int, int]) -> np.ndarray:
    """Decode + nearest resize, HW int32 (cityscapes_dataset.py:101,106)."""
    from PIL import Image

    native = _native()
    if native is not None:
        lab = np.asarray(_open_image(path, mode=None), np.uint8)
        if lab.ndim == 2:
            return native.resize_nearest(lab, crop_wh[1], crop_wh[0]).astype(np.int32)
    lab = _open_image(path, mode=None).resize(crop_wh, Image.NEAREST)
    return np.asarray(lab, np.int32)


def remap_gta5_ids(label: np.ndarray, ignore_label: int = 255) -> np.ndarray:
    """GTA5 label ids -> Cityscapes train ids, others -> ignore (gta5_dataset.py:60-63)."""
    out = np.full(label.shape, ignore_label, np.int32)
    for k, v in lists.GTA5_ID_TO_TRAINID.items():
        out[label == k] = v
    return out


@dataclass
class Sample:
    image_path: str
    label_path: Optional[str]
    name: str
    gta5_remap: bool = False


class CropCache:
    """On-disk cache of decoded and resized, un-mirrored uint8 crops.

    Training revisits each of the 2,975 Cityscapes images ~13 times over a 40k-step run
    and the reference decodes the PNG every time (cityscapes_dataset.py:97-120). The
    cache keeps the wire tensors after the resize (image: HWC uint8 BGR, label: HW uint8
    train ids with the GTA5 remap applied), so every epoch after the first decodes no
    PNG. The mirror is a width flip after the resize in the reference (:105,111-114), so
    flipping a cached crop equals decoding with the mirror: cached and uncached batches
    are equal bit for bit.

    Keyed on the source's absolute path, the crop size, the kind, its mtime and its
    size: a file regenerated at the same path (pseudo-labels between rounds) misses.
    Files are written atomically (a temporary file, then ``os.replace``), so workers
    racing on one entry all write the same bytes and readers never see half a file; an
    entry that does not load (truncated by a writer that died) is computed again.
    """

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, path: str, crop_wh: Tuple[int, int], kind: str) -> str:
        st = os.stat(path)
        h = hashlib.sha1(
            f"{os.path.abspath(path)}|{crop_wh[0]}x{crop_wh[1]}|{kind}"
            f"|{st.st_mtime_ns}|{st.st_size}".encode()
        ).hexdigest()[:24]
        return os.path.join(self.cache_dir, f"{h}_{kind}.npy")

    def get_or_put(self, path: str, crop_wh: Tuple[int, int], kind: str,
                   compute) -> np.ndarray:
        fname = self._key(path, crop_wh, kind)
        if os.path.exists(fname):
            try:
                return np.load(fname)
            except (OSError, ValueError, EOFError):
                pass  # truncated by a writer that died: compute and write again
        arr = compute()
        # Unique per writer; ends in .npy, so that np.save adds no suffix.
        tmp = f"{fname}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
        try:
            np.save(tmp, arr)
            os.replace(tmp, fname)
        except OSError:
            if os.path.exists(tmp):
                os.remove(tmp)
        return arr


class SegDataset:
    """The reference's three loader flavours over one class.

    - ``cityscapes_pseudo(root, lst)``: image + pseudo-label pairs (cityscapesPseudo,
      cityscapes_dataset.py:66-120), the SimT training input;
    - ``cityscapes_eval(root, txt, split)``: the image-only val list
      (cityscapesDataSet, :21-63);
    - ``gta5(root, txt)``: source images and labels with the id remap (GTA5DataSet).
    """

    def __init__(self, samples: List[Sample], crop_wh: Tuple[int, int],
                 mean_bgr: Sequence[float], mirror: bool = False, cache_dir: str = ""):
        self.samples = samples
        self.crop_wh = tuple(crop_wh)
        self.mean_bgr = tuple(mean_bgr)
        self.mirror = mirror
        self.cache_dir = cache_dir  # "" disables the crop cache
        self._cache = CropCache(cache_dir) if cache_dir else None

    def __getstate__(self):
        # Spawned workers rebuild the cache object (and its directory) on their side.
        st = dict(self.__dict__)
        st["_cache"] = None
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        if self.cache_dir:
            self._cache = CropCache(self.cache_dir)

    @classmethod
    def cityscapes_pseudo(cls, root: str, list_path: str, crop_wh, mean_bgr,
                          mirror: bool = False, cache_dir: str = ""):
        samples = [
            Sample(image_path=os.path.join(root, img), label_path=os.path.join(root, lab),
                   name=os.path.splitext(os.path.basename(lab))[0])
            for img, lab in lists.read_pair_list(list_path)
        ]
        return cls(samples, crop_wh, mean_bgr, mirror, cache_dir=cache_dir)

    @classmethod
    def cityscapes_eval(cls, root: str, list_path: str, crop_wh, mean_bgr,
                        split: str = "val"):
        samples = [
            Sample(image_path=os.path.join(root, split, name), label_path=None, name=name)
            for name in lists.read_name_list(list_path)
        ]
        return cls(samples, crop_wh, mean_bgr, mirror=False)

    @classmethod
    def gta5(cls, root: str, list_path: str, crop_wh, mean_bgr, mirror: bool = False,
             cache_dir: str = ""):
        samples = [
            Sample(image_path=os.path.join(root, "images", name),
                   label_path=os.path.join(root, "labels", name), name=name,
                   gta5_remap=True)
            for name in lists.read_name_list(list_path)
        ]
        return cls(samples, crop_wh, mean_bgr, mirror, cache_dir=cache_dir)

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        s = self.samples[index]
        mirror = bool(self.mirror and rng is not None and rng.integers(2) == 1)
        if self._cache is not None:
            image = self._cache.get_or_put(
                s.image_path, self.crop_wh, "img",
                lambda: load_image_bgr_u8(s.image_path, self.crop_wh, mirror=False))
            if mirror:
                image = image[:, ::-1]
        else:
            image = load_image_bgr_u8(s.image_path, self.crop_wh, mirror=mirror)
        out = {"image": np.ascontiguousarray(image), "name": s.name, "mirror": mirror}
        if s.label_path is not None:
            if self._cache is not None:
                label = self._cache.get_or_put(s.label_path, self.crop_wh, "lab",
                                               lambda: self._load_label(s))
            else:
                label = self._load_label(s)
            if mirror:
                label = label[:, ::-1]
            out["label"] = np.ascontiguousarray(label)
        return out

    def _load_label(self, s: Sample) -> np.ndarray:
        """Nearest-resized label in the uint8 wire format; the GTA5 remap is applied
        before the cache."""
        label = load_label(s.label_path, self.crop_wh)
        if s.gta5_remap:
            label = remap_gta5_ids(label)
        return label.astype(np.uint8)


_WORKER_DS: Optional[SegDataset] = None


def _worker_init(ds_bytes: bytes, use_native: bool) -> None:
    """Process-pool initializer: unpickle the dataset once a worker and carry the
    parent's ``USE_NATIVE`` over (a spawned worker imports this module afresh, which
    would reset the switch to its default)."""
    global _WORKER_DS, USE_NATIVE
    import pickle

    _WORKER_DS = pickle.loads(ds_bytes)
    USE_NATIVE = use_native


def _worker_get(args):
    idx, seed = args
    return _WORKER_DS.get(idx, np.random.default_rng(seed))


class Loader:
    """Epoch-free shuffled batch iterator with parallel decode.

    ``process_workers=True`` decodes in spawned worker processes (the reference's torch
    DataLoader model, trainV2_simt.py:287-292), which no interpreter lock can
    serialise; the JAX package chose them after its thread workers scaled negatively on
    PNG decode. The spawn context is used because the parent has CUDA initialised; a
    worker imports this module and the dataset's classes (and the parent's main
    script) and never touches CUDA. Spawning costs seconds a worker, so threads stay
    the default here; ``build_loader`` (train/loop.py) takes
    ``DataConfig.process_workers``.

    The index stream and one augmentation seed an item are drawn on the main thread in
    the JAX package's order, so for one seed threads, processes and the JAX loader
    yield the same batches. ``process_shard=(index, count)`` draws every peer's stream
    but decodes only block ``index`` of each ``count * batch_size`` global batch.

    The decode queue holds ``max(prefetch, num_workers + 2)`` batches, so that batch 1
    keeps every worker busy.
    """

    def __init__(
        self,
        dataset: SegDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 1234,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        loop: bool = True,
        process_workers: bool = False,
        process_shard: Optional[Tuple[int, int]] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.loop = loop
        self.process_workers = process_workers
        self.process_shard = process_shard

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(idx)
            yield from idx.tolist()
            if not self.loop:
                return

    def _pool(self):
        if not self.process_workers:
            ds = self.dataset
            return ThreadPoolExecutor(max_workers=self.num_workers), \
                lambda args: ds.get(args[0], np.random.default_rng(args[1]))
        import multiprocessing as mp
        import pickle
        from concurrent.futures import ProcessPoolExecutor

        _native()  # build the library here: a failure raises once, in the parent
        pool = ProcessPoolExecutor(max_workers=self.num_workers,
                                   mp_context=mp.get_context("spawn"),
                                   initializer=_worker_init,
                                   initargs=(pickle.dumps(self.dataset), USE_NATIVE))
        return pool, _worker_get

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + 1)
        stream = self._index_stream()
        stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, self.num_workers + 2))
        pool, get = self._pool()
        shard_idx, shard_cnt = self.process_shard or (0, 1)
        group = self.batch_size * shard_cnt

        def submit_batch():
            pairs = []
            for i in stream:
                # The augmentation seed is drawn here, on one thread, in stream order.
                pairs.append((i, int(rng.integers(2**63))))
                if len(pairs) == group:
                    break
            # Peers must agree on the global batch, so a short group is dropped when
            # sharded; otherwise drop_last decides.
            if len(pairs) < group and (shard_cnt > 1 or self.drop_last or not pairs):
                return None
            pairs = pairs[shard_idx * self.batch_size:(shard_idx + 1) * self.batch_size]
            return [pool.submit(get, pair) for pair in pairs]

        def producer():
            end = None
            try:
                while not stop.is_set():
                    futures = submit_batch()
                    if futures is None:
                        break
                    q.put(futures)
            except Exception as e:  # raised again on the consuming thread
                end = e
            finally:
                q.put(end)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                futures = q.get()
                if futures is None:
                    break
                if isinstance(futures, Exception):
                    raise futures
                items = [f.result() for f in futures]
                batch = {"image": np.stack([it["image"] for it in items])}
                if "label" in items[0]:
                    batch["label"] = np.stack([it["label"] for it in items])
                batch["name"] = [it["name"] for it in items]
                batch["mirror"] = [it["mirror"] for it in items]
                yield batch
        finally:
            stop.set()
            while thread.is_alive():  # unblock the producer, then let it end
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            pool.shutdown(wait=True, cancel_futures=True)


def device_prefetch(iterator: Iterator[Dict], size: int = 2,
                    device="cuda") -> Iterator[Dict]:
    """Overlap the host-to-device copies with the consumer's work: ``size`` batches
    stay in flight.

    On a CUDA ``device`` each numpy array of a batch is staged in pinned host memory and
    copied with ``non_blocking=True`` on a copy stream of its own; when the batch is
    handed out, the consumer's current stream waits on the copy's event and every
    tensor is marked with ``record_stream`` for it, so the caching allocator does not
    reuse its memory while the consumer's kernels may still read it. A pinned staging
    buffer goes back to PyTorch's pinned-memory cache when its batch is handed out, and
    that cache hands it out again only after the copy that read it has ended.
    Non-array entries (``name``, ``mirror``) pass through unchanged. On the CPU, when the
    caller names it, each array becomes ``torch.from_numpy`` of itself. Closing the
    returned iterator closes ``iterator`` (a ``Loader``'s stops its workers).

    The JAX package's ``sharding=`` (placement across a device mesh) has no counterpart
    until the parallel slice.
    """
    from ..device import resolve_device

    dev = resolve_device(device)  # raises here, not at the first batch
    return _prefetch(iterator, size, dev)


def _prefetch(iterator: Iterator[Dict], size: int, dev) -> Iterator[Dict]:
    import torch

    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        rest = {k: v for k, v in batch.items() if not isinstance(v, np.ndarray)}
        if copy_stream is None:
            return {k: torch.from_numpy(v) for k, v in arrays.items()}, rest, None
        with torch.cuda.stream(copy_stream):
            placed = {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
                      for k, v in arrays.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return placed, rest, done

    def take(entry):
        placed, rest, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in placed.values():
                t.record_stream(consumer)
        placed.update(rest)
        return placed

    buf: collections.deque = collections.deque()
    try:
        for batch in iterator:
            buf.append(put(batch))
            if len(buf) > size:
                yield take(buf.popleft())
        while buf:
            yield take(buf.popleft())
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:  # a Loader's iterator stops its workers
            close()
