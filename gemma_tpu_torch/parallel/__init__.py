"""Work across processes: `multihost` (process group, request routing, host
roles, the host-major mesh), `sharding` (the (data, model) mesh, its
collectives and placement plan) and `shard_decode` (Megatron shards and
`TPEngine`). Import the submodules."""
