"""Fleet's pipeline parallelism (counterpart of
``paddle_tpu/distributed/fleet``): the schedule oracles and the two
engines of :mod:`.pipeline`."""
