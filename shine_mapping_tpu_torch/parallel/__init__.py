"""Training on several cards: one process (rank) per card.

Port of ``shine_mapping_tpu/parallel``.  The JAX package is one controller
driving a device ``Mesh`` through ``shard_map`` and GSPMD; the port takes
PyTorch's idiom, ``torch.distributed`` with one rank per card (NCCL), or
several ranks sharing a card or the CPU (gloo).  ``mesh`` brings the ranks
up and places the training state, ``comm`` holds the few collectives the
trainer uses, ``ingest`` shards the data phase.
"""
