"""Scale-out layer on ``torch.distributed`` (port of ``parallel/``): the
rank mesh, the ring halo over the ordered-image axis, point-sharded
Schur-complement BA, the fused matching + BA step, and the multi-host
stages.

A process group takes the place of the JAX device mesh: gloo on the CPU
and for ranks that share one card, NCCL where each rank has a card of its
own. Collectives on device tensors are ``all_reduce`` sums alone, which
both backends run on CUDA tensors (gloo has no send/recv or all_gather
there).
"""
