"""N-Queens domain model + persistence.

Reference: `examples/nqueens/src/domain/*.rs`,
`persistence/domain_builder.rs` (seeded shuffle of row ids; solution
round-trip parses `"queens: {i}-->row_id"` names).
"""

from __future__ import annotations

import random


class Queen:
    def __init__(self, row_id, column_id):
        self.row_id = int(row_id)
        self.column_id = int(column_id)


class ChessBoard:
    def __init__(self, n, queens):
        self.n = int(n)
        self.queens = queens

    def conflict_count(self):
        """Host-side validity metric (acceptance check for tests)."""
        rows = [q.row_id for q in self.queens]
        desc = [q.column_id + q.row_id for q in self.queens]
        asc = [q.column_id - q.row_id for q in self.queens]
        n = len(rows)
        return (
            (n - len(set(rows)))
            + (n - len(set(desc)))
            + (n - len(set(asc)))
        )

    def __str__(self):
        keys = {(q.row_id, q.column_id) for q in self.queens}
        lines = []
        for i in range(self.n):
            lines.append(
                " ".join("+" if (i, j) in keys else "-" for j in range(self.n))
            )
        return "\n".join(lines)


class DomainBuilder:
    def __init__(self, n_queens, random_seed):
        self.n_queens = int(n_queens)
        self.random_seed = int(random_seed)

    def build_domain_from_scratch(self):
        row_ids = list(range(self.n_queens))
        rng = random.Random(self.random_seed)
        rng.shuffle(row_ids)
        queens = [Queen(row_ids[i], i) for i in range(self.n_queens)]
        return ChessBoard(self.n_queens, queens)

    def build_from_solution(self, solution, initial_domain=None):
        domain = self.build_domain_from_scratch()
        pairs = solution[0]
        for name, value in pairs:
            queen_id = int(name.split(" ")[1].split("-->")[0])
            domain.queens[queen_id].row_id = int(value)
        return domain

    def build_from_domain(self, domain):
        import copy

        return copy.deepcopy(domain)

    def clone(self):
        return DomainBuilder(self.n_queens, self.random_seed)
