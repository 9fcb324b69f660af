"""Server-side helpers the scheduler path calls. The broker, worker, plan
applier and FSM are the next slice of the port."""
