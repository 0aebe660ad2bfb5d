"""RPC admission control (port of doorman_tpu/admission): so far the
shed decision's shape (`policy.Shed`) and the grouped decide pass
(`coalesce.decide_grouped`) that the stream fanout uses."""
