"""Asynchronous local-mapping driver.

Port of orb_slam3_modified_tpu/mapping/async_mapper.py (LocalMapping on its
own thread, src/System.cc:197, polling mlNewKeyFrames in
src/LocalMapping.cc:64): keyframe processing (triangulation, fusion, local
BA) runs on a worker thread while the chunked tracker keeps dispatching
frames against the current map cache.

Hand-off. The tracker's keyframes are held until the tracker calls
release(), and the tracker reads the map only after wait_drained(): the
chunked tracker releases at the end of a chunk's retire and waits at the
start of the next one, so the worker runs while the next chunk is
dispatched, and every map the tracker reads is the one left by whole
batches of keyframes. No queue builds up, so every keyframe gets its local
BA (the reference skips it under a backlog). The reference hands each
keyframe over at once and
reads the map whenever its lock is free, so what the tracker saw depended
on the threads' timing; here it depends only on the frames.

init_fn(), when set, runs after each keyframe's local mapping, on the
worker: the asynchronous staged IMU init (ImuFrontend.run_pending_init, the
reference's LocalMapping::Run order, local BA then InitializeIMU / VIBA /
ScaleRefinement, src/LocalMapping.cc:148-244). It takes the map lock itself
(snapshot and commit under it, the solves without). The reference starts it
on a single-flight thread of its own; here it runs inline in the batch, so
wait_drained() covers it and the frames' results do not depend on when it
finished.

post_fn(k), when set, runs right after keyframe k's local mapping (and the
init hook), on the worker and under the map lock: the loop closer
(loop/loop_closer.py), in the reference's pipeline order LocalMapping ->
LoopClosing (src/LocalMapping.cc:255 region). It is part of the batch, so
the tracker's wait_drained() covers it, global BA included.

One map lock serializes map mutation (worker) against the tracker's host
reads and writes (Map::mMutexMapUpdate). On a CUDA device the worker issues
its device work on a stream of its own, so it never queues behind the
tracker's chunk steps on the default stream, and everything it hands the
tracker crosses through the numpy map: each device result is read back
(one event sync) before it is committed under the lock. The few device
tensors it does hand over (the IMU frontend's bias after an init or a VI
BA) are complete when wait_drained() returns: the worker synchronizes its
stream at the end of each batch.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import torch

from .local_mapper import LocalMapper


class AsyncLocalMapper:
    def __init__(self, mapper: LocalMapper, post_fn=None):
        self.mapper = mapper
        self.post_fn = post_fn
        self.init_fn = None
        self.lock = threading.RLock()
        mapper.lock = self.lock  # fine-grained phase locking inside
        self.stream = None
        if mapper.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=mapper.device)
            # the mapper's constants were written on the creating stream
            self.stream.wait_stream(torch.cuda.current_stream(mapper.device))
        self.queue: queue.Queue = queue.Queue()  # batches of (k, frame id)
        self._held: list = []
        self.processed = 0
        self.errors: list = []
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def on_keyframe(self, k: int):
        """Tracker-side hook: hold the keyframe until release(). The slot's
        frame id rides along so the worker skips a slot culled (and reused)
        meanwhile."""
        self._held.append((int(k), int(self.mapper.map.kf_frame_id[k])))

    def release(self):
        """Hand the held keyframes to the worker as one batch."""
        if self._held:
            self.queue.put(self._held)
            self._held = []

    def busy(self) -> bool:
        """Backlogged, not merely working: NeedNewKeyFrame still inserts
        while KeyframesInQueue() < 3 (src/Tracking.cc:3099 region). The
        tracker asks between wait_drained() and release(), when the worker
        is idle: it will take the first held keyframe at once, and the rest
        wait in the queue."""
        return len(self._held) - 1 >= 3

    def _run(self):
        ctx = torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()
        with ctx:
            while not self._stop:
                try:
                    batch = self.queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                try:
                    for k, fid in batch:
                        m = self.mapper.map
                        if not m.kf_valid[k] or int(m.kf_frame_id[k]) != fid:
                            continue  # slot culled (or culled and reused) since the hand-off
                        self.mapper.on_keyframe(k)
                        if self.init_fn is not None:
                            self.init_fn()
                        if self.post_fn is not None:
                            with self.lock:
                                self.post_fn(k)
                        self.processed += 1
                except Exception as e:  # surfaced by wait_drained(); the thread lives on
                    self.errors.append((batch, repr(e)))
                finally:
                    if self.stream is not None:
                        self.stream.synchronize()
                    self.queue.task_done()

    def wait_drained(self):
        """Block until every released keyframe is processed (held ones stay
        held); raises the worker's errors. Call WITHOUT the map lock (the
        worker needs it to progress)."""
        self.queue.join()
        if self.errors:
            raise RuntimeError(f"async mapper errors: {self.errors}")

    def flush(self):
        """Release the held keyframes and block until all are processed (end
        of sequence, tests); raises the worker's errors."""
        self.release()
        self.wait_drained()

    def shutdown(self):
        self._stop = True
        self._worker.join(timeout=5.0)
