"""Runnable examples of the port, counterparts of the reference's
`examples/*.py` (the same problems, options, physics checks and `OK` line):

    python -m fea_large_tpu_torch.examples.uniaxial_tension
    python -m fea_large_tpu_torch.examples.beam_bending
    python -m fea_large_tpu_torch.examples.block_compression [n]
    python -m fea_large_tpu_torch.examples.distributed_compression [shards]

Each runs on the card, or on the CPU where FEA_PLATFORM=cpu (no fallback:
without CUDA and without that switch it fails); the distributed one on one
process per shard (one NCCL rank per card, or gloo ranks on the CPU).
"""
