"""MeasurementJournal: crash-safe, append-only record of completed measurements.

Benchmarking time is the scarce resource the whole PR methodology conserves,
so an interrupted campaign must never re-pay for measurements it already made.
The journal is a JSONL file with one record per completed scheduler chunk::

    {"v": 1, "platform": "<cache key>", "layer_type": "dense",
     "params": ["tokens", "d_in"], "rows": [[16, 32], ...], "seconds": [...]}

Block chunks (whole-network calibration) share the same file with
``"kind": "blocks"`` records that serialize a whole
:class:`~repro_torch.core.batch.BlockBatch` payload; replay routes them into the
cache's block table, so one journal resumes both pipeline stages.

Each append is flushed and ``fsync``'d before the scheduler moves on, so after
a crash the journal holds exactly the chunks whose measurements completed.  On
the next run :meth:`replay_into` preloads the records into the campaign's
:class:`~repro_torch.api.cache.MeasurementCache` (via ``cache.preload``, which does
not disturb hit/miss accounting), turning every journaled configuration into a
cache hit — the run resumes with zero duplicate measurements.

Truncated or corrupt lines (the tail of a crashed write, manual edits) are
skipped with a warning instead of aborting the replay; everything before them
is still recovered.  Python floats round-trip exactly through JSON, so a
resumed campaign is bitwise-identical to an uninterrupted one.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Iterator

import numpy as np

from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.runtime.faults import JOURNAL_SITE, TornWrite

RECORD_VERSION = 1
_REQUIRED_KEYS = ("platform", "layer_type", "params", "rows", "seconds")
_REQUIRED_BLOCK_KEYS = ("platform", "blocks", "seconds")


class JournalCorruptionWarning(UserWarning):
    """A journal line could not be parsed/validated and was skipped."""


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is itself durable (POSIX).

    ``os.replace`` makes the swap atomic, but the *directory entry* only
    becomes durable once the directory inode is flushed — without this a
    power cut after compaction could resurrect the old (longer) journal.
    Best-effort: platforms that cannot open directories just skip it.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _validate_record(record) -> dict:
    """Validate one parsed journal record; raises on any malformation."""
    if not isinstance(record, dict):
        raise ValueError("record is not an object")
    if record.get("kind") == "blocks":
        for key in _REQUIRED_BLOCK_KEYS:
            if key not in record:
                raise ValueError(f"missing key {key!r}")
        # Rebuilding the batch validates the whole payload
        # (shapes, index ranges); raises on malformed input.
        batch = BlockBatch.from_payload(record["blocks"])
        if len(batch) != len(record["seconds"]):
            raise ValueError("blocks/seconds length mismatch")
        np.asarray(record["seconds"], dtype=np.float64)
    else:
        for key in _REQUIRED_KEYS:
            if key not in record:
                raise ValueError(f"missing key {key!r}")
        if len(record["rows"]) != len(record["seconds"]):
            raise ValueError("rows/seconds length mismatch")
        n_params = len(record["params"])
        for row in record["rows"]:
            if not isinstance(row, list) or len(row) != n_params:
                raise ValueError("malformed config row")
        # Values must parse too, or replay would abort mid-file
        # on e.g. a bit-flipped cell; raises on non-numeric.
        np.asarray(record["rows"], dtype=np.int64)
        np.asarray(record["seconds"], dtype=np.float64)
    return record


def _record_keys(record) -> list[tuple]:
    """Canonical per-measurement keys of a valid record (compaction's keys)."""
    if record.get("kind") == "blocks":
        batch = BlockBatch.from_payload(record["blocks"])
        return [(record["platform"], fp) for fp in batch.fingerprints()]
    params = tuple(record["params"])
    return [
        (record["platform"], record["layer_type"], tuple(sorted(zip(params, row))))
        for row in record["rows"]
    ]


class MeasurementJournal:
    """Append-only JSONL journal of ``(platform, layer_type, config) -> seconds``.

    ``fault_plan`` (a :class:`~repro_torch.runtime.faults.FaultPlan`) lets chaos
    tests tear individual appends mid-record; production journals never pass
    one and take the plain fsync'd append path.
    """

    def __init__(self, path: str, fault_plan=None) -> None:
        self.path = path
        self._fh = None
        self._fault_plan = fault_plan
        self._appends = 0
        #: torn tails sealed before appending (see :meth:`_append_record`)
        self.sealed_tails = 0
        self._needs_seal = False

    # ------------------------------------------------------------------ write
    def _open(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # A file that does not end in a newline carries the torn tail of
            # a crashed append; flag it so the next append seals it first.
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                with open(self.path, "rb") as tail:
                    tail.seek(-1, os.SEEK_END)
                    self._needs_seal = tail.read(1) != b"\n"
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def _append_record(self, record: dict) -> None:
        """Durably append one record (write + flush + fsync).

        If the file currently ends mid-record (a previous torn write), a
        bare newline is sealed in first: replay then skips the torn
        fragment as *one* corrupt line instead of the fragment swallowing
        this record too.
        """
        fh = self._open()
        if self._needs_seal:
            fh.write("\n")
            self._needs_seal = False
            self.sealed_tails += 1
            obs_metrics().inc("journal.torn_tails_sealed")
        line = json.dumps(record, separators=(",", ":")) + "\n"
        ordinal = self._appends
        self._appends += 1
        if self._fault_plan is not None:
            event = self._fault_plan.take(JOURNAL_SITE, ordinal)
            if event is not None:
                # Tear the write exactly as a crash mid-write(2) would:
                # half the bytes, no newline, durably on disk.
                fh.write(line[: max(1, len(line) // 2)])
                fh.flush()
                os.fsync(fh.fileno())
                self._needs_seal = True
                raise TornWrite(f"injected torn journal write at append {ordinal}")
        fh.write(line)
        fh.flush()
        os.fsync(fh.fileno())

    def append_chunk(
        self, platform: str, layer_type: str, batch: ConfigBatch, seconds: np.ndarray
    ) -> None:
        """Durably record one measured chunk (write + flush + fsync)."""
        if len(batch) == 0:
            return
        self._append_record(
            {
                "v": RECORD_VERSION,
                "platform": platform,
                "layer_type": layer_type,
                "params": list(batch.params),
                "rows": batch.values.tolist(),
                "seconds": np.asarray(seconds, dtype=np.float64).tolist(),
            }
        )

    def append_block_chunk(
        self, platform: str, batch: BlockBatch, seconds: np.ndarray
    ) -> None:
        """Durably record one measured *block* chunk (write + flush + fsync).

        Block records carry ``"kind": "blocks"`` and serialize the whole
        :class:`BlockBatch` via its JSON payload; they share the journal file
        with config records, so one campaign journal resumes both the
        single-layer and the whole-network calibration stages.
        """
        if len(batch) == 0:
            return
        self._append_record(
            {
                "v": RECORD_VERSION,
                "kind": "blocks",
                "platform": platform,
                "blocks": batch.to_payload(),
                "seconds": np.asarray(seconds, dtype=np.float64).tolist(),
            }
        )

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MeasurementJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- read
    def iter_records(self) -> Iterator[dict]:
        """Yield valid records; skip corrupt/truncated lines with a warning."""
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    record = _validate_record(json.loads(line))
                except (ValueError, TypeError, KeyError) as exc:
                    # Counted before warning: a warnings filter can silence
                    # the message, but a skipped line must stay visible in
                    # the metrics snapshot (``counters["journal.corrupt_lines"]``).
                    obs_metrics().inc("journal.corrupt_lines")
                    warnings.warn(
                        f"{self.path}:{lineno}: skipping corrupt journal line ({exc})",
                        JournalCorruptionWarning,
                        stacklevel=2,
                    )
                    continue
                yield record

    # ------------------------------------------------------------------- fsck
    def fsck(self, repair: bool = False) -> dict:
        """Check journal integrity; with ``repair=True``, rewrite it clean.

        Detects the three ways a journal degrades in practice:

        * **torn tail** — the file does not end in a newline (a crash mid
          append); the fragment costs one corrupt line on replay until the
          next append seals it;
        * **corrupt lines** — unparseable/ill-shaped records (bit rot,
          manual edits), skipped by replay;
        * **duplicate keys** — the same measurement recorded more than once
          (retry-superseded chunks, restarted runs) — legal, since replay is
          last-writer-wins, but bloat; ``kind_switches`` counts config/block
          record interleavings, a proxy for how fragmented the file is.

        Repair routes through the existing compaction path (validated
        records only, last value under first-occurrence keys, atomic
        replace), which by construction fixes all of the above without
        changing what a replay yields.  Returns the report dict; when
        repaired, ``"compaction"`` holds :meth:`compact`'s stats and the
        post-repair state is re-checked into ``"after"``.
        """
        report = {
            "path": self.path,
            "exists": os.path.exists(self.path),
            "records": 0,
            "rows": 0,
            "corrupt_lines": 0,
            "torn_tail": False,
            "duplicate_keys": 0,
            "kind_switches": 0,
            "repaired": False,
        }
        if not report["exists"]:
            return report
        self.close()  # a buffered append handle would race the scan
        with open(self.path, "rb") as fh:
            data = fh.read()
        report["torn_tail"] = len(data) > 0 and not data.endswith(b"\n")
        seen: set[tuple] = set()
        last_kind = None
        for raw in data.split(b"\n"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                record = _validate_record(json.loads(raw.decode("utf-8")))
            except (ValueError, TypeError, KeyError, UnicodeDecodeError):
                report["corrupt_lines"] += 1
                continue
            report["records"] += 1
            kind = "blocks" if record.get("kind") == "blocks" else "configs"
            if last_kind is not None and kind != last_kind:
                report["kind_switches"] += 1
            last_kind = kind
            for key in _record_keys(record):
                if key in seen:
                    report["duplicate_keys"] += 1
                else:
                    seen.add(key)
                    report["rows"] += 1
        if repair:
            report["compaction"] = self.compact()
            report["repaired"] = True
            after = self.fsck(repair=False)
            report["after"] = {
                k: after[k]
                for k in ("records", "rows", "corrupt_lines", "torn_tail",
                          "duplicate_keys", "kind_switches")
            }
        return report

    # ---------------------------------------------------------------- compact
    def compact(self) -> dict[str, int]:
        """Rewrite the journal with one record per measurement (GC for JSONL).

        A long campaign's journal accumulates duplicates: retried chunks
        append superseding records, restarted runs re-journal overlapping
        grids, and the file only ever grows.  Compaction rewrites it keeping
        exactly one copy of each unique measurement — the **final** value
        (replay is last-writer-wins, see :meth:`replay_into`) under the
        **first-occurrence** key order, so replaying the compacted journal
        populates a cache bitwise-identically to replaying the original.

        Config rows are canonicalised by their sorted ``(param, value)``
        items, so the same configuration journaled under differently-ordered
        param tuples still compacts to one row (owned by the group that saw
        it first).  Block records compact per platform by measurement
        fingerprint.  The rewrite is crash-safe: staged to ``<path>.tmp``,
        fsync'd, then atomically ``os.replace``'d over the original.

        Returns ``{"records_in", "records_out", "rows_in", "rows_out",
        "bytes_in", "bytes_out"}``.
        """
        if not os.path.exists(self.path):
            return {
                "records_in": 0, "records_out": 0, "rows_in": 0,
                "rows_out": 0, "bytes_in": 0, "bytes_out": 0,
            }
        self.close()  # the append handle would keep writing past the rewrite
        bytes_in = os.path.getsize(self.path)

        final: dict[tuple, float] = {}          # canonical key -> last value
        order: list[tuple] = []                 # group keys, first occurrence
        group_rows: dict[tuple, list[tuple]] = {}   # cfg group -> owned keys
        row_values: dict[tuple, list[int]] = {}     # owned key -> row (group order)
        block_parts: dict[str, list] = {}       # platform -> owned sub-batches
        block_keys: dict[str, list[tuple]] = {} # platform -> owned keys, in order
        records_in = rows_in = 0

        for record in self.iter_records():
            records_in += 1
            if record.get("kind") == "blocks":
                platform = record["platform"]
                batch = BlockBatch.from_payload(record["blocks"])
                rows_in += len(batch)
                group = ("blk", platform)
                keys = [(platform, fp) for fp in batch.fingerprints()]
                owned = []
                for i, (key, sec) in enumerate(zip(keys, record["seconds"])):
                    if key not in final:
                        if platform not in block_parts:
                            order.append(group)
                            block_parts[platform] = []
                            block_keys[platform] = []
                        owned.append(i)
                        block_keys[platform].append(key)
                    final[key] = float(sec)
                if owned:
                    block_parts[platform].append(
                        batch.take(np.asarray(owned, dtype=np.int64))
                    )
                continue
            platform, layer_type = record["platform"], record["layer_type"]
            params = tuple(record["params"])
            group = ("cfg", platform, layer_type, params)
            rows_in += len(record["rows"])
            for row, sec in zip(record["rows"], record["seconds"]):
                key = (platform, layer_type, tuple(sorted(zip(params, row))))
                if key not in final:
                    if group not in group_rows:
                        order.append(group)
                        group_rows[group] = []
                    group_rows[group].append(key)
                    row_values[key] = [int(v) for v in row]
                final[key] = float(sec)

        tmp = self.path + ".tmp"
        records_out = rows_out = 0
        with open(tmp, "w", encoding="utf-8") as fh:
            for group in order:
                if group[0] == "blk":
                    _, platform = group
                    merged = BlockBatch.concat(block_parts[platform])
                    record = {
                        "v": RECORD_VERSION,
                        "kind": "blocks",
                        "platform": platform,
                        "blocks": merged.to_payload(),
                        "seconds": [final[k] for k in block_keys[platform]],
                    }
                    rows_out += len(merged)
                else:
                    _, platform, layer_type, params = group
                    keys = group_rows[group]
                    record = {
                        "v": RECORD_VERSION,
                        "platform": platform,
                        "layer_type": layer_type,
                        "params": list(params),
                        "rows": [row_values[k] for k in keys],
                        "seconds": [final[k] for k in keys],
                    }
                    rows_out += len(keys)
                fh.write(json.dumps(record, separators=(",", ":")) + "\n")
                records_out += 1
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        # The data hit disk before the rename; flush the rename itself too.
        _fsync_dir(os.path.dirname(self.path) or ".")
        self._needs_seal = False  # the rewrite never ends mid-record
        return {
            "records_in": records_in,
            "records_out": records_out,
            "rows_in": rows_in,
            "rows_out": rows_out,
            "bytes_in": bytes_in,
            "bytes_out": os.path.getsize(self.path),
        }

    def replay_into(self, cache) -> dict[str, int]:
        """Preload journaled measurements into a ``MeasurementCache``.

        Replay is **last-writer-wins** (``cache.preload`` overwrites): the
        journal is chronological, and the scheduler appends a superseding
        record when a retried chunk's merged values differ from what a stale
        attempt journaled — the final record for a key is always the value
        the run trained on.  Returns ``{"records": .., "rows": .., "new": ..}``
        where ``new`` counts keys not already cached (re-replays are
        idempotent).
        """
        records = rows = new = 0
        for record in self.iter_records():
            if record.get("kind") == "blocks":
                block_batch = BlockBatch.from_payload(record["blocks"])
                if len(block_batch) == 0:
                    continue
                new += cache.preload_blocks(
                    record["platform"], block_batch, record["seconds"]
                )
                records += 1
                rows += len(block_batch)
                continue
            values = np.asarray(record["rows"], dtype=np.int64)
            if values.size == 0:
                continue
            batch = ConfigBatch(params=tuple(record["params"]), values=values)
            new += cache.preload(
                record["platform"], record["layer_type"], batch, record["seconds"]
            )
            records += 1
            rows += len(batch)
        return {"records": records, "rows": rows, "new": new}
