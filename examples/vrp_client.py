"""Standalone VRP service client — this build's counterpart of the
reference's python client
(`examples/vrp_service/python_client/scripts/solve_vrp_by_rust_service.py:1-70`):
build a task payload from a domain (here a generated instance, or a `.vrp`
file if you have one), submit it to a running solver service, then stream
every fresh global-best solution the observer publishes until the service
sends the "Solving finished" sentinel.

Start the server first:
    python examples/vrp_service_example.py server
then run this client:
    python examples/vrp_client.py [--host 127.0.0.1] [--port 8077]
                                  [--vrp-file path/to/instance.vrp]
                                  [--customers 50 --depots 2 --vehicles 10]
"""

import argparse
import json
import pathlib
import sys
import urllib.error
import urllib.request

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from greyjack_tpu.service.solver_service import domain_to_task_json


def build_task(args):
    if args.vrp_file:
        from greyjack_tpu.models.vrp import DomainBuilder
        domain = DomainBuilder(args.vrp_file).build_domain_from_scratch()
    else:
        from greyjack_tpu.models.vrp import generate_instance
        domain = generate_instance(args.customers, args.depots, args.vehicles,
                                   seed=args.seed, time_windowed=True)
    task = domain_to_task_json(domain)
    # the reference client tags tasks with user/task ids (`:54-55`); the
    # service echoes unknown fields back, so the tags survive the round-trip
    task["user_id"] = 13
    task["task_id"] = 45
    return task


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--vrp-file", default=None)
    ap.add_argument("--customers", type=int, default=50)
    ap.add_argument("--depots", type=int, default=2)
    ap.add_argument("--vehicles", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    base = f"http://{args.host}:{args.port}"
    task = build_task(args)
    req = urllib.request.Request(f"{base}/tasks",
                                 data=json.dumps(task).encode(),
                                 method="POST")
    urllib.request.urlopen(req)
    print(f"submitted task to {base}/tasks "
          f"({task['customers_dict']['n_customers']} customers, "
          f"{task['metadata']['vehicles_count']} vehicles); "
          "streaming solutions:")

    while True:
        try:
            resp = urllib.request.urlopen(f"{base}/solutions", timeout=120)
        except urllib.error.URLError as e:
            print(f"service unreachable: {e}", file=sys.stderr)
            return 1
        solution = json.loads(resp.read())
        if solution == "Solving finished":
            print("done")
            return 0
        if solution is None:  # no fresh global best yet — poll again
            continue
        print(f"distance={solution['sum_travel_distance']:.3f} "
              f"unique_stops={solution['unique_stops']} "
              f"trips={len(solution['trips'])}")


if __name__ == "__main__":
    raise SystemExit(main())
