"""The engine's device funnel and the host state it reads (port of
``shodh_tpu/engine``): ``DeviceRecallEngine``, feedback momentum, L5 scoring
and decay."""
