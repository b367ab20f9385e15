"""Multi-device: a (data, model) mesh of ranks under torch.distributed, one
process a device. The port of openhush_tpu/parallel/: `sharding` holds the
mesh, the reference's parameter rules and the tensor-parallel collectives;
`world` starts and joins the ranks; `dryrun` is the multi-device dry run."""
