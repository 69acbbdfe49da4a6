"""Training and serving steps of the port: the loss, the optimizers, the
sharding rules and the step builders."""
