"""Multi-GPU paths on torch.distributed (port of `madrigal_tpu/parallel/`).

One process per rank. The JAX package's mesh axes become process groups
of a `torch.distributed.device_mesh.DeviceMesh`:

  * 'dp'    -- data parallel over the DDI triples (stage 3), the drug
               batch (stage 2) and the drug list (embedding); with
               `kg_shard_axis`, the KG's edges as well (graph parallel);
  * 'label' -- outcome parallel over the decoder weight [L, D, D] and the
               all-pairs score and rank tensors.

Modules: `mesh` (the mesh and its axis groups), `multihost` (process
group set-up, the hybrid mesh, host-local shards), `collectives` (the
autograd Functions the segment ops and the trainers share), `kg_shard`
(edge-sharded HGT), `allpairs` (label-sharded scores and ranks,
dp-sharded embedding), `train_step` (the sharded trainers) and `dryrun`
(the seven sharded paths against one device). Nothing is imported here,
so `import madrigal_tpu_torch.parallel` costs nothing.
"""
