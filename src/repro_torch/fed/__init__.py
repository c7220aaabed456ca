from repro_torch.fed.worker import Worker, WorkerConfig, make_worker_configs  # noqa: F401
from repro_torch.fed.rounds import (  # noqa: F401
    RoundEngine, RoundState, WireConfig, WirePath, init_round_state,
    load_round_state, participation_mask, participation_masks,
    save_round_state, scan_rounds,
)
from repro_torch.fed.simulator import FedSimulator, SimResult  # noqa: F401
