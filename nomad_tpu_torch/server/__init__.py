"""The server loop: eval broker, worker, plan queue, plan pipeline, FSM and
the single-process Server (copies of nomad_tpu/server, imports rewritten)."""
