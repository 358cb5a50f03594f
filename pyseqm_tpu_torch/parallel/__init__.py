from .sharding import (MoleculeMesh, free_port,  # noqa: F401
                       gather_molecules, make_train_step, molecule_mesh,
                       pad_to_mesh, shard_molecules, sharded_energy_fn,
                       sharded_force_fn, sharded_xlbomd_step, spawn_ranks,
                       xlbomd_state_specs)
