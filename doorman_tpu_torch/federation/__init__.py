"""Federation (port of doorman_tpu/federation): so far the stable shard
hash (`router.stable_shard`)."""
