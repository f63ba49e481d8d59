"""VRP solving service example — mirrors
`examples/vrp_service/src/main.rs` + its python client, using
the HTTP broker (RabbitMQ adapter available via
`greyjack_tpu.service.brokers.RabbitMqBroker` when pika + a broker exist).

Run server:  python examples/vrp_service_example.py server
Run client:  python examples/vrp_service_example.py client
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import json
import sys
import urllib.request

from greyjack_tpu.compile_cache import enable_compile_cache
from greyjack_tpu.service import SolverService, HttpBroker
from greyjack_tpu.service.solver_service import domain_to_task_json
from greyjack_tpu.models.vrp import generate_instance
from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import ScoreNoImprovement
from greyjack_tpu.solver import SolverLoggingLevels

PORT = 8077


def agent_factory():
    return TabuSearch(1024, 0.2, True, None, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
                      10, ScoreNoImprovement(5_000))


def server():
    enable_compile_cache()
    broker = HttpBroker(port=PORT)
    service = SolverService(broker, agent_factory, n_jobs=8,
                            logging_level=SolverLoggingLevels.FreshOnly)
    print(f"VRP service listening on :{broker.port}")
    service.serve_forever()


def client():
    domain = generate_instance(50, 2, 10, seed=1, time_windowed=True)
    task = domain_to_task_json(domain)
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}/tasks", data=json.dumps(task).encode(),
        method="POST")
    urllib.request.urlopen(req)
    while True:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{PORT}/solutions",
                                      timeout=60)
        solution = json.loads(resp.read())
        if solution == "Solving finished":
            print("done")
            break
        if solution is None:
            continue
        print(f"distance={solution['sum_travel_distance']:.3f} "
              f"unique_stops={solution['unique_stops']}")


if __name__ == "__main__":
    (server if "server" in sys.argv[1:] else client)()
