"""Island-model runner: vmapped agents + ring migration + global best.

Reference mechanism (`solver/solver.rs:85-143`, `agent_base.rs:124-188`):
`n_jobs` OS threads over a directed ring of bounded(1) channels, a mutexed
global best, migrants exchanged every `migration_frequency` steps. Device
redesign (SURVEY.md §2.3):

  * islands are a leading array axis `[I, ...]`; one jitted chunk advances
    every island `migration_frequency` steps via `lax.scan` + `vmap`;
  * ring migration = `jnp.roll` along the island axis on one device, and
    `lax.ppermute` across mesh devices under `shard_map` (receivers rotated
    by one — island i receives from island i-1, `solver.rs:88-92`);
  * the shared global best = lexicographic min over island bests
    (all-gather + reduce under the mesh), replacing the `Arc<Mutex>` CAS
    (`agent_base.rs:446-490`);
  * dead islands are frozen by masking (`agent_base.rs:137-146`) but keep
    relaying — their (frozen) best still circulates, matching dead agents
    that transmit until everyone is done (`agent_base.rs:157-159`).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import base as agent_base
from greyjack_tpu.agents import late_acceptance as la_mod
from greyjack_tpu.ops import lexico


class IslandRunner:
    def __init__(self, kernel, n_islands, migration_frequency, mesh=None,
                 compare_to_global=True):
        self.kernel = kernel
        self.n_islands = int(n_islands)
        self.migration_frequency = int(migration_frequency)
        self.mesh = mesh
        self.compare_to_global = compare_to_global
        self.kind = kernel.metaheuristic_kind
        p = kernel.population_size
        if self.kind == "Population":
            self.migrants_count = max(1, math.ceil(kernel.migration_rate * p))
        else:
            self.migrants_count = 1
        self._chunk_cache = {}
        if mesh is not None:
            axis_size = mesh.shape["islands"]
            if self.n_islands % axis_size != 0:
                raise ValueError(
                    f"n_islands={self.n_islands} must divide evenly over the "
                    f"{axis_size}-device islands mesh axis"
                )

    # --- init ---------------------------------------------------------------
    def init(self, key):
        # jitted: eager execution would compile and dispatch every
        # primitive separately
        keys = jax.random.split(key, self.n_islands)
        islands = jax.jit(jax.vmap(self.kernel.init_state))(keys)
        s = islands["scores"].shape[-1]
        v = islands["population"].shape[-1]
        state = {
            "islands": islands,
            "global_values": jnp.zeros((v,), islands["population"].dtype),
            "global_score": lexico.stub_score_row(s),
        }
        if self.mesh is not None:
            state = jax.device_put(state, self._sharding(state))
        return state

    def _sharding(self, state):
        from jax.sharding import NamedSharding, PartitionSpec as P

        def spec(path_is_island, leaf):
            return NamedSharding(
                self.mesh, P("islands", *([None] * (leaf.ndim - 1)))
            )

        island_shard = jax.tree.map(lambda l: spec(True, l), state["islands"])
        rep = jax.tree.map(
            lambda l: NamedSharding(self.mesh, P()),
            {k: v for k, v in state.items() if k != "islands"},
        )
        return {"islands": island_shard, **rep}

    # --- chunk --------------------------------------------------------------
    def run_chunk(self, state, key, alive, extras, n_steps, steps_left=None):
        """Advance all islands `n_steps` steps, then migrate + reduce best.

        alive: bool[I]; extras: dict of f64[I] per-island scalars. Entries
        named `<k>_end` pair with `<k>` to linearly interpolate the value
        across the chunk's steps (per-step SA auto-temperature,
        `agent_base.rs:537-552`). `steps_left`: i32[I] per-island step
        budget — islands freeze after their budget inside a full-size chunk,
        so StepsLimit stays exact WITHOUT compiling a trimmed chunk program
        per distinct remainder (a chunk compile takes seconds to minutes).
        """
        if steps_left is None:
            steps_left = jnp.full(alive.shape, n_steps, jnp.int32)
        fn = self._get_chunk_fn(int(n_steps))
        return fn(state, key, alive, steps_left, extras)

    def _get_chunk_fn(self, n_steps):
        if n_steps not in self._chunk_cache:
            if self.mesh is None:
                fn = jax.jit(partial(self._chunk_local, n_steps=n_steps))
            else:
                from jax.sharding import PartitionSpec as P

                islands_spec = P("islands")

                def sharded(state, key, alive, steps_left, extras):
                    in_specs = (
                        {
                            "islands": jax.tree.map(
                                lambda _: islands_spec, state["islands"]
                            ),
                            "global_values": P(),
                            "global_score": P(),
                        },
                        P(),
                        islands_spec,
                        islands_spec,
                        jax.tree.map(lambda _: islands_spec, extras),
                    )
                    out_specs = in_specs[0]
                    return jax.shard_map(
                        partial(self._chunk_sharded, n_steps=n_steps),
                        mesh=self.mesh,
                        in_specs=in_specs,
                        out_specs=out_specs,
                        # the global best is replicated by construction (an
                        # argmin over all-gathered island tops), but public
                        # `lax.all_gather` is typed varying -> varying, so
                        # the default check rejects the P() out_specs
                        check_vma=False,
                    )(state, key, alive, steps_left, extras)

                fn = jax.jit(sharded)
            self._chunk_cache[n_steps] = fn
        return self._chunk_cache[n_steps]

    # --- inner bodies -------------------------------------------------------
    def _steps(self, islands, key, alive, steps_left, extras, n_steps,
               n_local):
        step = self.kernel.step
        ends = {k for k in extras if k.endswith("_end")}
        lerped = {k for k in extras if k + "_end" in ends}

        def body(carry, i):
            st, k = carry
            k, sub = jax.random.split(k)
            keys = jax.random.split(sub, n_local)
            # per-step extras: lerp `<k>`..`<k>_end` by step index — the SA
            # auto-temperature is re-derived before EVERY step in the
            # reference (`agent_base.rs:537-552`); for StepsLimit the
            # accomplish rate is linear in steps, so the lerp is exact
            frac = i.astype(jnp.float64) / n_steps
            ex = {
                k2: (v + (extras[k2 + "_end"] - v) * frac)
                if k2 in lerped else v
                for k2, v in extras.items() if k2 not in ends
            }
            act = alive & (i < steps_left)
            if self.kernel.prestep is not None:
                ex = {**ex, **self.kernel.prestep(st)}
            if self.kernel.self_gating:
                # the kernel freezes its own writes when inactive — no
                # whole-state where-tree per step (it breaks the scan-carry
                # buffer alias and costs ~25 selects over MBs of ctx)
                new = jax.vmap(step)(keys, st, {**ex, "_active": act})
            else:
                new = jax.vmap(step)(keys, st, ex)
                new = agent_base.mask_state(new, st, act)
            return (new, k), None

        (islands, _), _ = jax.lax.scan(
            body, (islands, key), jnp.arange(n_steps, dtype=jnp.int32)
        )
        return islands

    def _chunk_local(self, state, key, alive, steps_left, extras, n_steps):
        islands = self._steps(
            state["islands"], key, alive, steps_left, extras, n_steps,
            self.n_islands
        )
        islands = self._migrate(islands, roll_fn=lambda x: jnp.roll(x, 1, axis=0))
        state = self._update_global(state, islands, gather_fn=None)
        return self._refresh(state)

    def _chunk_sharded(self, state, key, alive, steps_left, extras, n_steps):
        axis = "islands"
        n_local = self.n_islands // self.mesh.shape[axis]
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        islands = self._steps(
            state["islands"], key, alive, steps_left, extras, n_steps, n_local
        )

        def ring_roll(x):
            # local shift by one; the island leaving this shard's top goes to
            # the next device (`ppermute`), closing the global ring
            n_dev = jax.lax.axis_size(axis)
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            boundary = jax.lax.ppermute(x[-1:], axis, perm)
            return jnp.concatenate([boundary, x[:-1]], axis=0)

        islands = self._migrate(islands, roll_fn=ring_roll)

        def gather_fn(tops_v, tops_s):
            return (
                jax.lax.all_gather(tops_v, axis, tiled=True),
                jax.lax.all_gather(tops_s, axis, tiled=True),
            )

        state = self._update_global(state, islands, gather_fn=gather_fn)
        return self._refresh(state)

    def _refresh(self, state):
        """Re-derive population-dependent state (delta-scoring ctx) after
        migration / global-best adoption replaced individuals — once per
        chunk (amortized O(N))."""
        if self.kernel.refresh is None:
            return state
        state = dict(state)
        state["islands"] = jax.vmap(self.kernel.refresh)(state["islands"])
        return state

    def _migrate(self, islands, roll_fn):
        """Ring exchange + acceptance (`agent_base.rs:322-444`)."""
        k = self.migrants_count
        pop = islands["population"]  # [I, P, V]
        scores = islands["scores"]  # [I, P, S]
        p = pop.shape[1]

        if self.kind == "Population":
            mig_v = roll_fn(pop[:, :k])
            mig_s = roll_fn(scores[:, :k])
            tgt_v = pop[:, p - k:]
            tgt_s = scores[:, p - k:]
            accept = lexico.lex_leq(mig_s, tgt_s)  # [I, k]
            new_tgt_v = jnp.where(accept[..., None], mig_v, tgt_v)
            new_tgt_s = jnp.where(accept[..., None], mig_s, tgt_s)
            pop = pop.at[:, p - k:].set(new_tgt_v)
            scores = scores.at[:, p - k:].set(new_tgt_s)
            # keep the sorted-population invariant
            def resort(s, v):
                return lexico.lex_sort_scores_with(s, v)

            scores, pop = jax.vmap(resort)(scores, pop)
        else:
            mig_v = roll_fn(pop[:, 0])
            mig_s = roll_fn(scores[:, 0])
            if "late" in islands:
                # LA acceptance vs deque-oldest (`agent_base.rs:416-428`)
                oldest = jax.vmap(la_mod.ring_oldest)(islands["late"], scores[:, 0])
                accept = lexico.lex_leq(mig_s, oldest) | lexico.lex_leq(
                    mig_s, scores[:, 0]
                )
                islands = dict(islands)
                islands["late"] = jax.vmap(la_mod.ring_push_front)(
                    islands["late"], mig_s, accept
                )
            else:
                accept = lexico.lex_leq(mig_s, scores[:, 0])
            pop = pop.at[:, 0].set(jnp.where(accept[:, None], mig_v, pop[:, 0]))
            scores = scores.at[:, 0].set(
                jnp.where(accept[:, None], mig_s, scores[:, 0])
            )

        islands = dict(islands)
        islands["population"] = pop
        islands["scores"] = scores
        islands = jax.vmap(agent_base.update_top)(islands)
        return islands

    def _update_global(self, state, islands, gather_fn):
        """Lexicographic global-best reduce + per-MH adoption
        (`agent_base.rs:446-490`)."""
        tops_v = islands["top_values"]  # [I, V]
        tops_s = islands["top_score"]  # [I, S]
        if gather_fn is not None:
            all_v, all_s = gather_fn(tops_v, tops_s)
        else:
            all_v, all_s = tops_v, tops_s
        cand_v = jnp.concatenate([all_v, state["global_values"][None]], axis=0)
        cand_s = jnp.concatenate([all_s, state["global_score"][None]], axis=0)
        best = lexico.lex_argmin(cand_s)
        g_v = cand_v[best]
        g_s = cand_s[best]

        if self.kind == "LocalSearch" and self.compare_to_global:
            # adopt the global best when strictly better than the island top
            adopt = lexico.lex_less(g_s, islands["top_score"])  # [I]
            if "late" in islands:
                islands = dict(islands)
                islands["late"] = jax.vmap(la_mod.ring_push_front)(
                    islands["late"], islands["scores"][:, 0], adopt
                )
            pop = islands["population"]
            scores = islands["scores"]
            pop = pop.at[:, 0].set(
                jnp.where(adopt[:, None], g_v[None, :], pop[:, 0])
            )
            scores = scores.at[:, 0].set(
                jnp.where(adopt[:, None], g_s[None, :], scores[:, 0])
            )
            islands = dict(islands)
            islands["population"] = pop
            islands["scores"] = scores

        return {"islands": islands, "global_values": g_v, "global_score": g_s}
