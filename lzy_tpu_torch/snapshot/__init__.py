from lzy_tpu_torch.snapshot.snapshot import Snapshot, SnapshotEntry

__all__ = ["Snapshot", "SnapshotEntry"]
