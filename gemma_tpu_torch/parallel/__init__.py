"""Work across processes: `multihost` (process group, request routing, host
roles). The tensor-parallel half of the reference's `parallel/`
(`sharding.py`, `shard_decode.py`) is not ported yet."""
