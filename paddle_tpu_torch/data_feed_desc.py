"""fluid.DataFeedDesc parity (``python/paddle/fluid/data_feed_desc.py``).

The reference wraps a data_feed.proto text message configuring the
AsyncExecutor's MultiSlot reader.  Protobuf-free here: the same
text-format file is parsed into slot descriptors, which an AsyncExecutor
reads (``.slot_names``, ``.batch_size``; the port's AsyncExecutor is
ROADMAP queue 1 item 11).

The port's own copy of ``paddle_tpu/data_feed_desc.py``, which needs
``re`` only."""

import re

__all__ = ["DataFeedDesc"]


class DataFeedDesc:
    def __init__(self, proto_file):
        self.name = "MultiSlotDataFeed"
        self.batch_size = 1
        self._slots = []          # [{"name","type","is_dense","is_used"}]
        with open(proto_file) as f:
            text = f.read()
        self._parse(text)

    def _parse(self, text):
        # top-level fields live BEFORE multi_slot_desc — searching the
        # whole file would grab the first slot's name instead
        head = text.split("multi_slot_desc")[0]
        m = re.search(r'name:\s*"([^"]+)"', head)
        if m:
            self.name = m.group(1)
        m = re.search(r"batch_size:\s*(\d+)", head)
        if m:
            self.batch_size = int(m.group(1))
        for blk in re.findall(r"slots\s*\{([^}]*)\}", text):
            # proto3 bool default: false (data_feed.proto) — slots are
            # opted IN via is_used/set_use_slots
            slot = {"name": "", "type": "uint64", "is_dense": False,
                    "is_used": False}
            m = re.search(r'name:\s*"([^"]+)"', blk)
            if m:
                slot["name"] = m.group(1)
            m = re.search(r'type:\s*"([^"]+)"', blk)
            if m:
                slot["type"] = m.group(1)
            m = re.search(r"is_dense:\s*(\w+)", blk)
            if m:
                slot["is_dense"] = m.group(1) == "true"
            m = re.search(r"is_used:\s*(\w+)", blk)
            if m:
                slot["is_used"] = m.group(1) == "true"
            self._slots.append(slot)

    # reference mutators (data_feed_desc.py:57-59)
    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_dense_slots(self, dense_slots_name):
        names = set(dense_slots_name)
        for s in self._slots:
            if s["name"] in names:
                s["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        # additive, like the reference (data_feed_desc.py: only sets
        # use_slots[i] = true for the named slots)
        names = set(use_slots_name)
        for s in self._slots:
            if s["name"] in names:
                s["is_used"] = True

    @property
    def slot_names(self):
        return [s["name"] for s in self._slots if s["is_used"]]

    @property
    def used_slot_indices(self):
        """Positions of used slots within the RECORD's slot order — the
        consumer (AsyncExecutor) selects record slots by these indices
        so unused slots can never misalign the feed."""
        return [i for i, s in enumerate(self._slots) if s["is_used"]]

    def desc(self):
        """Dump back to the text format (debugging parity)."""
        lines = [f'name: "{self.name}"',
                 f"batch_size: {self.batch_size}", "multi_slot_desc {"]
        for s in self._slots:
            lines += ["  slots {", f'    name: "{s["name"]}"',
                      f'    type: "{s["type"]}"',
                      f'    is_dense: {str(s["is_dense"]).lower()}',
                      f'    is_used: {str(s["is_used"]).lower()}', "  }"]
        lines.append("}")
        return "\n".join(lines)
