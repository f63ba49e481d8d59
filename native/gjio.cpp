// gjio — native IO for greyjack_tpu.
//
// The reference solver's host runtime is Rust end-to-end; this build keeps
// the compute path in XLA and implements the host-bound pieces natively.
// This library provides the data-loader: a fast tokenizer for TSPLIB (.tsp)
// and CVRPLIB-style (.vrp) instance files (the reference's
// `examples/tsp/src/persistence/domain_builder.rs:92-213` and
// `examples/vrp/src/persistence/domain_builder.rs:145-316` re-done as a
// single-pass scanner instead of per-line regex splitting).
//
// Exposed C ABI (ctypes-friendly): parse into caller-inspectable flat
// buffers owned by a parse handle.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParseResult {
  // metadata
  char name[256] = {0};
  char edge_weight_type[64] = {0};
  int64_t capacity = -1;
  int64_t vehicles_count = -1;
  // node coord section: id, x, y per node
  std::vector<int64_t> ids;
  std::vector<double> xs;
  std::vector<double> ys;
  // demand section rows (vrp): id, demand [, tw_start, tw_end, service]
  std::vector<int64_t> demand_rows;  // flattened, stride = demand_stride
  int64_t demand_stride = 0;
  // depot section (vrp)
  std::vector<int64_t> depot_ids;
  // explicit distance matrix (non-EUC_2D)
  std::vector<double> matrix;
  int64_t matrix_rows = 0;
  std::string error;
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

bool line_contains(const char* p, const char* end, const char* needle) {
  const char* le = p;
  while (le < end && *le != '\n') le++;
  size_t n = strlen(needle);
  for (const char* q = p; q + n <= le; q++) {
    if (memcmp(q, needle, n) == 0) return true;
  }
  return false;
}

// parse all whitespace-separated numeric tokens on the current line
int parse_line_doubles(const char* p, const char* end, double* out, int max_n) {
  const char* le = p;
  while (le < end && *le != '\n') le++;
  int n = 0;
  const char* q = p;
  while (q < le && n < max_n) {
    q = skip_ws(q, le);
    if (q >= le) break;
    char* after = nullptr;
    double v = strtod(q, &after);
    if (after == q) {  // non-numeric token (e.g. a name column): skip it
      while (q < le && *q != ' ' && *q != '\t') q++;
      continue;
    }
    out[n++] = v;
    q = after;
  }
  return n;
}

void parse_keyword_line(const char* p, const char* end, ParseResult* r) {
  const char* le = p;
  while (le < end && *le != '\n') le++;
  std::string line(p, le - p);
  auto last_token = [&line]() -> std::string {
    size_t e = line.find_last_not_of(" \t\r");
    if (e == std::string::npos) return "";
    size_t s = line.find_last_of(" \t:", e);
    return line.substr(s == std::string::npos ? 0 : s + 1, e - s);
  };
  if (line.find("NAME") != std::string::npos) {
    std::string name = last_token();
    snprintf(r->name, sizeof(r->name), "%s", name.c_str());
    // reference parses the vehicle count from the NAME's "-kNN" suffix
    size_t kpos = name.rfind("-k");
    if (kpos != std::string::npos) {
      r->vehicles_count = strtoll(name.c_str() + kpos + 2, nullptr, 10);
    }
  } else if (line.find("EDGE_WEIGHT_TYPE") != std::string::npos) {
    snprintf(r->edge_weight_type, sizeof(r->edge_weight_type), "%s",
             last_token().c_str());
  } else if (line.find("CAPACITY") != std::string::npos) {
    r->capacity = strtoll(last_token().c_str(), nullptr, 10);
  }
}

}  // namespace

extern "C" {

ParseResult* gj_parse_instance(const char* path) {
  auto* r = new ParseResult();
  FILE* f = fopen(path, "rb");
  if (!f) {
    r->error = std::string("failed to open ") + path;
    return r;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    r->error = "short read";
    fclose(f);
    return r;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + size;
  enum Section { META, COORDS, MATRIX, DEMAND, DEPOT, DONE } section = META;
  double tmp[8];

  while (p < end && section != DONE) {
    switch (section) {
      case META:
        if (line_contains(p, end, "NODE_COORD_SECTION")) {
          section = COORDS;
        } else {
          parse_keyword_line(p, end, r);
        }
        break;
      case COORDS: {
        if (line_contains(p, end, "DEMAND_SECTION")) { section = DEMAND; break; }
        if (line_contains(p, end, "EOF")) {
          // tsp with explicit matrix follows; vrp never hits this
          section = MATRIX;
          break;
        }
        int n = parse_line_doubles(p, end, tmp, 3);
        if (n >= 3) {
          r->ids.push_back(static_cast<int64_t>(tmp[0]));
          r->xs.push_back(tmp[1]);
          r->ys.push_back(tmp[2]);
        }
        break;
      }
      case MATRIX: {
        if (line_contains(p, end, "EOF")) { section = DONE; break; }
        std::vector<double> row(r->ids.size());
        int n = parse_line_doubles(p, end, row.data(), (int)row.size());
        if (n > 0) {
          r->matrix.insert(r->matrix.end(), row.begin(), row.begin() + n);
          r->matrix_rows++;
        }
        break;
      }
      case DEMAND: {
        if (line_contains(p, end, "DEPOT_SECTION")) { section = DEPOT; break; }
        if (line_contains(p, end, "EOF")) { section = DONE; break; }
        int n = parse_line_doubles(p, end, tmp, 5);
        if (n >= 2) {
          if (r->demand_stride == 0) r->demand_stride = n;
          for (int i = 0; i < r->demand_stride; i++) {
            r->demand_rows.push_back(
                static_cast<int64_t>(i < n ? tmp[i] : 0.0));
          }
        }
        break;
      }
      case DEPOT: {
        if (line_contains(p, end, "EOF") || line_contains(p, end, "-1")) {
          section = DONE;
          break;
        }
        int n = parse_line_doubles(p, end, tmp, 1);
        if (n == 1) r->depot_ids.push_back(static_cast<int64_t>(tmp[0]));
        break;
      }
      case DONE:
        break;
    }
    p = next_line(p, end);
  }
  return r;
}

void gj_free(ParseResult* r) { delete r; }

const char* gj_error(ParseResult* r) {
  return r->error.empty() ? nullptr : r->error.c_str();
}
const char* gj_name(ParseResult* r) { return r->name; }
const char* gj_edge_weight_type(ParseResult* r) { return r->edge_weight_type; }
int64_t gj_capacity(ParseResult* r) { return r->capacity; }
int64_t gj_vehicles_count(ParseResult* r) { return r->vehicles_count; }

int64_t gj_n_nodes(ParseResult* r) { return (int64_t)r->ids.size(); }
const int64_t* gj_node_ids(ParseResult* r) { return r->ids.data(); }
const double* gj_node_xs(ParseResult* r) { return r->xs.data(); }
const double* gj_node_ys(ParseResult* r) { return r->ys.data(); }

int64_t gj_demand_stride(ParseResult* r) { return r->demand_stride; }
int64_t gj_n_demand_rows(ParseResult* r) {
  return r->demand_stride ? (int64_t)r->demand_rows.size() / r->demand_stride : 0;
}
const int64_t* gj_demand_rows(ParseResult* r) { return r->demand_rows.data(); }

int64_t gj_n_depots(ParseResult* r) { return (int64_t)r->depot_ids.size(); }
const int64_t* gj_depot_ids(ParseResult* r) { return r->depot_ids.data(); }

int64_t gj_matrix_rows(ParseResult* r) { return r->matrix_rows; }
const double* gj_matrix(ParseResult* r) { return r->matrix.data(); }

}  // extern "C"
