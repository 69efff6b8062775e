// dsat: a compact CDCL SAT solver + WalkSAT + model enumerator with a C ABI.
//
// This is the native solver layer of DiffusionSAT. It replaces the
// reference's external solver binaries (lingeling/treengeling/walksat) and
// pysat's in-process Glucose (reference satsolvers/*.py, utils/sat.py:91-162)
// with one self-contained library: data generation needs a fast SAT check +
// one model; diffusion-uniformity benchmarking needs full model enumeration
// and uniform sampling.
//
// CDCL features: 2-watched literals, 1UIP conflict analysis with clause
// minimization-lite, VSIDS activities, phase saving, Luby restarts,
// optional random polarity (for diverse model sampling).
//
// Wire format (DIMACS-flat): clauses passed as a flat int32 array of signed
// 1-based literals, each clause terminated by 0.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>
#include <limits>

namespace {

typedef int Lit;   // internal literal: 2*v (pos) | 2*v+1 (neg)
typedef int Var;

static inline Lit mklit(Var v, bool sign) { return v * 2 + (sign ? 1 : 0); }
static inline Var litvar(Lit l) { return l >> 1; }
static inline bool litsign(Lit l) { return l & 1; }  // true => negated
static inline Lit litneg(Lit l) { return l ^ 1; }

// xoshiro256** PRNG
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
    for (int i = 0; i < 4; i++) {
      z += 0x9E3779B97F4A7C15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xBF58476D1CE4E5B9ULL;
      t = (t ^ (t >> 27)) * 0x94D049BB133111EBULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  // uniform in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

struct Clause {
  std::vector<Lit> lits;
  bool learnt;
  double activity;
};

enum LBool : int8_t { L_UNDEF = 0, L_TRUE = 1, L_FALSE = -1 };

struct Watcher { int cref; Lit blocker; };

struct Solver {
  int n_vars = 0;
  std::vector<Clause> clauses;                 // clause database (originals + learnt)
  std::vector<std::vector<Watcher>> watches;   // indexed by literal
  std::vector<LBool> assigns;                  // per var
  std::vector<int> level;                      // per var
  std::vector<int> reason;                     // per var: clause ref or -1
  std::vector<Lit> trail;
  std::vector<int> trail_lim;
  std::vector<double> activity;                // VSIDS per var
  std::vector<bool> polarity;                  // saved phase per var (true = assign false)
  std::vector<bool> seen;
  double var_inc = 1.0;
  double var_decay = 0.95;
  double cla_inc = 1.0;
  int qhead = 0;
  bool ok = true;
  bool rand_polarity = false;
  Rng rng;
  long long conflicts = 0;
  long long conflict_budget = -1;  // -1 = unlimited
  // order heap replaced by simple activity-scan (fine at our sizes) — but we
  // keep a lazily-rebuilt sorted candidate cache to stay near O(n log n).

  explicit Solver(uint64_t seed) : rng(seed) {}

  void ensure_vars(int n) {
    n_vars = n;
    watches.assign(2 * n, {});
    assigns.assign(n, L_UNDEF);
    level.assign(n, 0);
    reason.assign(n, -1);
    activity.assign(n, 0.0);
    polarity.assign(n, true);  // default phase: false (like minisat)
    seen.assign(n, false);
  }

  LBool value(Lit l) const {
    LBool v = assigns[litvar(l)];
    if (v == L_UNDEF) return L_UNDEF;
    return (LBool)(litsign(l) ? -v : v);
  }

  int decision_level() const { return (int)trail_lim.size(); }

  bool add_clause_lits(std::vector<Lit>& ls, bool learnt) {
    if (!learnt) {
      std::sort(ls.begin(), ls.end());
      int j = 0;
      Lit prev = -2;
      for (int i = 0; i < (int)ls.size(); i++) {
        if (ls[i] == litneg(prev)) return true;  // tautology: a v ~a
        if (ls[i] == prev) continue;             // duplicate literal
        // drop literals already false at level 0
        if (decision_level() == 0 && value(ls[i]) == L_FALSE) { continue; }
        if (decision_level() == 0 && value(ls[i]) == L_TRUE) return true;  // satisfied
        ls[j++] = ls[i];
        prev = ls[i];
      }
      ls.resize(j);
    }
    if (ls.empty()) { ok = false; return false; }
    if (ls.size() == 1) {
      if (value(ls[0]) == L_FALSE) { ok = false; return false; }
      if (value(ls[0]) == L_UNDEF) unchecked_enqueue(ls[0], -1);
      return ok = (propagate() == -1);
    }
    int cref = (int)clauses.size();
    clauses.push_back({ls, learnt, 0.0});
    watches[litneg(ls[0])].push_back({cref, ls[1]});
    watches[litneg(ls[1])].push_back({cref, ls[0]});
    return true;
  }

  void unchecked_enqueue(Lit l, int from) {
    assigns[litvar(l)] = litsign(l) ? L_FALSE : L_TRUE;
    level[litvar(l)] = decision_level();
    reason[litvar(l)] = from;
    trail.push_back(l);
  }

  // returns conflicting clause ref or -1
  int propagate() {
    while (qhead < (int)trail.size()) {
      Lit p = trail[qhead++];
      std::vector<Watcher>& ws = watches[p];
      int i = 0, j = 0;
      int conf = -1;
      for (; i < (int)ws.size();) {
        Watcher w = ws[i];
        if (value(w.blocker) == L_TRUE) { ws[j++] = ws[i++]; continue; }
        Clause& c = clauses[w.cref];
        // make sure c.lits[1] is the false literal (== ~p)
        Lit false_lit = litneg(p);
        if (c.lits[0] == false_lit) std::swap(c.lits[0], c.lits[1]);
        // 0th watch true => clause satisfied
        Lit first = c.lits[0];
        if (first != w.blocker && value(first) == L_TRUE) {
          ws[j++] = {w.cref, first}; i++; continue;
        }
        // look for a new watch
        bool found = false;
        for (int k = 2; k < (int)c.lits.size(); k++) {
          if (value(c.lits[k]) != L_FALSE) {
            std::swap(c.lits[1], c.lits[k]);
            watches[litneg(c.lits[1])].push_back({w.cref, first});
            found = true;
            break;
          }
        }
        if (found) { i++; continue; }
        // clause is unit or conflicting
        ws[j++] = {w.cref, first}; i++;
        if (value(first) == L_FALSE) {
          conf = w.cref;
          qhead = (int)trail.size();
          while (i < (int)ws.size()) ws[j++] = ws[i++];
          break;
        } else {
          unchecked_enqueue(first, w.cref);
        }
      }
      ws.resize(j);
      if (conf != -1) return conf;
    }
    return -1;
  }

  void var_bump(Var v) {
    activity[v] += var_inc;
    if (activity[v] > 1e100) {
      for (int i = 0; i < n_vars; i++) activity[i] *= 1e-100;
      var_inc *= 1e-100;
    }
  }

  void analyze(int conf, std::vector<Lit>& out_learnt, int& out_btlevel) {
    int path_c = 0;
    Lit p = -1;
    out_learnt.clear();
    out_learnt.push_back(-1);  // placeholder for asserting literal
    int index = (int)trail.size() - 1;
    do {
      Clause& c = clauses[conf];
      if (c.learnt) c.activity += cla_inc;
      for (int k = (p == -1) ? 0 : 1; k < (int)c.lits.size(); k++) {
        Lit q = c.lits[k];
        Var v = litvar(q);
        if (!seen[v] && level[v] > 0) {
          var_bump(v);
          seen[v] = true;
          if (level[v] >= decision_level()) path_c++;
          else out_learnt.push_back(q);
        }
      }
      while (!seen[litvar(trail[index])]) index--;
      p = trail[index--];
      conf = reason[litvar(p)];
      seen[litvar(p)] = false;
      path_c--;
    } while (path_c > 0);
    out_learnt[0] = litneg(p);

    // simple self-subsumption-lite minimization: drop literals whose reason
    // clause literals are all seen
    std::vector<Lit> minimized;
    minimized.push_back(out_learnt[0]);
    for (int i = 1; i < (int)out_learnt.size(); i++) {
      Var v = litvar(out_learnt[i]);
      int r = reason[v];
      bool redundant = false;
      if (r != -1) {
        redundant = true;
        for (Lit q : clauses[r].lits) {
          Var qv = litvar(q);
          if (qv != v && !seen[qv] && level[qv] > 0) { redundant = false; break; }
        }
      }
      if (!redundant) minimized.push_back(out_learnt[i]);
    }
    // clear seen for ALL pre-minimization literals (minimized-away ones too)
    for (Lit q : out_learnt) seen[litvar(q)] = false;
    out_learnt.swap(minimized);

    // find backtrack level
    if (out_learnt.size() == 1) out_btlevel = 0;
    else {
      int max_i = 1;
      for (int i = 2; i < (int)out_learnt.size(); i++)
        if (level[litvar(out_learnt[i])] > level[litvar(out_learnt[max_i])]) max_i = i;
      std::swap(out_learnt[1], out_learnt[max_i]);
      out_btlevel = level[litvar(out_learnt[1])];
    }
    for (Lit q : out_learnt) seen[litvar(q)] = false;
  }

  void cancel_until(int lvl) {
    if (decision_level() <= lvl) return;
    for (int c = (int)trail.size() - 1; c >= trail_lim[lvl]; c--) {
      Var v = litvar(trail[c]);
      assigns[v] = L_UNDEF;
      polarity[v] = litsign(trail[c]);  // phase saving
      reason[v] = -1;
    }
    qhead = trail_lim[lvl];
    trail.resize(trail_lim[lvl]);
    trail_lim.resize(lvl);
  }

  Var pick_branch_var() {
    Var best = -1;
    double best_act = -1.0;
    for (Var v = 0; v < n_vars; v++) {
      if (assigns[v] == L_UNDEF && activity[v] > best_act) {
        best_act = activity[v];
        best = v;
      }
    }
    return best;
  }

  static double luby(double y, int x) {
    int size, seq;
    for (size = 1, seq = 0; size < x + 1; seq++, size = 2 * size + 1) {}
    while (size - 1 != x) { size = (size - 1) >> 1; seq--; x = x % size; }
    return std::pow(y, seq);
  }

  // Drop the least-active half of unlocked learnt clauses and rebuild
  // watches (keeps memory bounded on hard instances).
  void reduce_db() {
    std::vector<double> acts;
    for (int i = n_original; i < (int)clauses.size(); i++)
      if (clauses[i].learnt) acts.push_back(clauses[i].activity);
    if (acts.size() < 2000) return;
    std::nth_element(acts.begin(), acts.begin() + acts.size() / 2,
                     acts.end());
    double cutoff = acts[acts.size() / 2];

    std::vector<bool> locked(clauses.size(), false);
    for (Lit p : trail) {
      int r = reason[litvar(p)];
      if (r >= 0) locked[r] = true;
    }
    std::vector<int> remap(clauses.size(), -1);
    std::vector<Clause> kept;
    kept.reserve(clauses.size());
    for (int i = 0; i < (int)clauses.size(); i++) {
      bool keep = i < n_original || !clauses[i].learnt || locked[i] ||
                  clauses[i].activity >= cutoff ||
                  clauses[i].lits.size() <= 2;
      if (keep) {
        remap[i] = (int)kept.size();
        kept.push_back(std::move(clauses[i]));
      }
    }
    clauses.swap(kept);
    for (Var v = 0; v < n_vars; v++)
      if (reason[v] >= 0) reason[v] = remap[reason[v]];
    for (auto& ws : watches) ws.clear();
    for (int i = 0; i < (int)clauses.size(); i++) {
      Clause& c = clauses[i];
      if (c.lits.size() >= 2) {
        watches[litneg(c.lits[0])].push_back({i, c.lits[1]});
        watches[litneg(c.lits[1])].push_back({i, c.lits[0]});
      }
    }
  }

  // returns L_TRUE (sat), L_FALSE (unsat), L_UNDEF (budget exhausted)
  LBool solve() {
    if (n_original == 0) n_original = (int)clauses.size();
    if (!ok) return L_FALSE;
    int restart_n = 0;
    long long next_reduce = 20000;
    for (;;) {
      long long restart_budget = (long long)(luby(2.0, restart_n++) * 64);
      LBool r = search(restart_budget);
      if (r != L_UNDEF) return r;
      if (conflict_budget >= 0 && conflicts >= conflict_budget) return L_UNDEF;
      cancel_until(0);
      if (conflicts >= next_reduce) {
        reduce_db();
        next_reduce = conflicts + 20000;
      }
    }
  }

  int n_original = 0;

  LBool search(long long budget) {
    long long local_conflicts = 0;
    std::vector<Lit> learnt;
    for (;;) {
      int conf = propagate();
      if (conf != -1) {
        conflicts++;
        local_conflicts++;
        if (decision_level() == 0) return L_FALSE;
        int bt;
        analyze(conf, learnt, bt);
        cancel_until(bt);
        if (learnt.size() == 1) {
          unchecked_enqueue(learnt[0], -1);
        } else {
          int cref = (int)clauses.size();
          clauses.push_back({learnt, true, cla_inc});
          watches[litneg(learnt[0])].push_back({cref, learnt[1]});
          watches[litneg(learnt[1])].push_back({cref, learnt[0]});
          unchecked_enqueue(learnt[0], cref);
        }
        var_inc /= var_decay;
      } else {
        if (local_conflicts >= budget) return L_UNDEF;
        if (conflict_budget >= 0 && conflicts >= conflict_budget) return L_UNDEF;
        Var next = pick_branch_var();
        if (next == -1) return L_TRUE;  // all assigned: model found
        bool sign;
        if (rand_polarity) sign = rng.below(2) == 1;
        else sign = polarity[next];
        trail_lim.push_back((int)trail.size());
        unchecked_enqueue(mklit(next, sign), -1);
      }
    }
  }
};

// Parse DIMACS-flat literal array into a solver.
bool load_flat(Solver& s, int n_vars, const int32_t* lits, int64_t n_lits) {
  s.ensure_vars(n_vars);
  std::vector<Lit> cur;
  for (int64_t i = 0; i < n_lits; i++) {
    int32_t l = lits[i];
    if (l == 0) {
      if (!s.add_clause_lits(cur, false)) return false;
      cur.clear();
    } else {
      int v = (l > 0 ? l : -l) - 1;
      if (v >= n_vars) return false;
      cur.push_back(mklit(v, l < 0));
    }
  }
  if (!cur.empty()) {
    if (!s.add_clause_lits(cur, false)) return false;
  }
  return s.ok;
}

void extract_model(const Solver& s, int8_t* model) {
  for (int v = 0; v < s.n_vars; v++)
    model[v] = (s.assigns[v] == L_TRUE) ? 1 : 0;
}

}  // namespace

extern "C" {

// Solve. Returns 1 SAT (model filled with 0/1 per var), 0 UNSAT, -1 budget
// exhausted / error.
int dsat_solve(int n_vars, const int32_t* lits, int64_t n_lits, int8_t* model,
               uint64_t seed, int rand_polarity, long long conflict_budget) {
  Solver s(seed);
  s.rand_polarity = rand_polarity != 0;
  s.conflict_budget = conflict_budget;
  if (!load_flat(s, n_vars, lits, n_lits)) return 0;
  LBool r = s.solve();
  if (r == L_TRUE) { extract_model(s, model); return 1; }
  if (r == L_FALSE) return 0;
  return -1;
}

// Solve with model-seeded search: optional initial phases (init_polarity
// per var: -1 = solver default, 0/1 = preferred value — branching tries
// the model's predicted bit first) and optional initial VSIDS activities
// (init_activity per var, nullable — confidence-ordered decisions before
// conflict-driven bumping takes over). Reports the conflict count in
// *out_conflicts (always set). Returns like dsat_solve. This is the seam
// for the neural-input-prior study: CDCL guided by the ANF model's
// predicted input-bit marginals vs plain CDCL.
int dsat_solve_seeded(int n_vars, const int32_t* lits, int64_t n_lits,
                      int8_t* model, uint64_t seed,
                      const int8_t* init_polarity,
                      const float* init_activity,
                      long long conflict_budget,
                      long long* out_conflicts) {
  Solver s(seed);
  s.conflict_budget = conflict_budget;
  if (!load_flat(s, n_vars, lits, n_lits)) {
    if (out_conflicts) *out_conflicts = s.conflicts;
    return 0;
  }
  if (init_polarity) {
    for (int v = 0; v < n_vars; v++)
      if (init_polarity[v] >= 0) s.polarity[v] = (init_polarity[v] == 0);
  }
  if (init_activity) {
    for (int v = 0; v < n_vars; v++)
      s.activity[v] = (double)init_activity[v];
  }
  LBool r = s.solve();
  if (out_conflicts) *out_conflicts = s.conflicts;
  if (r == L_TRUE) { extract_model(s, model); return 1; }
  if (r == L_FALSE) return 0;
  return -1;
}

// Enumerate up to max_models models (blocking-clause loop). Fills models
// row-major [found, n_vars] (0/1). Returns the number found; if the
// enumeration completed (no more models), sets *complete=1.
long long dsat_enumerate(int n_vars, const int32_t* lits, int64_t n_lits,
                         int8_t* models, long long max_models,
                         uint64_t seed, int* complete) {
  *complete = 0;
  Solver s(seed);
  if (!load_flat(s, n_vars, lits, n_lits)) { *complete = 1; return 0; }
  long long found = 0;
  std::vector<int8_t> cur_model(n_vars);
  while (found < max_models) {
    LBool r = s.solve();
    if (r == L_FALSE) { *complete = 1; break; }
    if (r == L_UNDEF) break;
    extract_model(s, cur_model.data());
    if (models) std::memcpy(models + found * n_vars, cur_model.data(), n_vars);
    found++;
    // blocking clause: the literal falsified by the model for every var
    // (if var is true add ~v, else v), added at decision level 0.
    s.cancel_until(0);
    std::vector<Lit> block(n_vars);
    for (int v = 0; v < n_vars; v++) block[v] = mklit(v, cur_model[v] == 1);
    if (!s.add_clause_lits(block, false) || !s.ok) { *complete = 1; break; }
  }
  return found;
}

// WalkSAT (SKC variant with noise). Returns 1 if a model was found within
// max_flips, else 0. model must hold n_vars bytes; used as the initial
// assignment if init_from_model != 0.
int dsat_walksat(int n_vars, const int32_t* lits, int64_t n_lits, int8_t* model,
                 uint64_t seed, long long max_flips, double noise,
                 int init_from_model) {
  // Build clause structures
  std::vector<std::vector<int>> cls;     // signed 1-based per clause
  std::vector<std::vector<int>> occ(n_vars);  // clause ids per var
  {
    std::vector<int> cur;
    for (int64_t i = 0; i < n_lits; i++) {
      if (lits[i] == 0) {
        if (!cur.empty()) {
          int cid = (int)cls.size();
          cls.push_back(cur);
          for (int l : cur) occ[std::abs(l) - 1].push_back(cid);
          cur.clear();
        }
      } else cur.push_back(lits[i]);
    }
    if (!cur.empty()) {
      int cid = (int)cls.size();
      cls.push_back(cur);
      for (int l : cur) occ[std::abs(l) - 1].push_back(cid);
    }
  }
  int m = (int)cls.size();
  Rng rng(seed);
  std::vector<int8_t> x(n_vars);
  if (init_from_model) for (int v = 0; v < n_vars; v++) x[v] = model[v] ? 1 : 0;
  else for (int v = 0; v < n_vars; v++) x[v] = (int8_t)rng.below(2);

  auto lit_true = [&](int l) {
    int v = std::abs(l) - 1;
    return (l > 0) == (x[v] == 1);
  };
  std::vector<int> sat_count(m, 0);   // # true literals per clause
  std::vector<int> unsat;             // ids of unsat clauses
  std::vector<int> unsat_pos(m, -1);
  auto mark_unsat = [&](int c) { unsat_pos[c] = (int)unsat.size(); unsat.push_back(c); };
  auto unmark_unsat = [&](int c) {
    int p = unsat_pos[c];
    int last = unsat.back();
    unsat[p] = last; unsat_pos[last] = p;
    unsat.pop_back(); unsat_pos[c] = -1;
  };
  for (int c = 0; c < m; c++) {
    for (int l : cls[c]) if (lit_true(l)) sat_count[c]++;
    if (sat_count[c] == 0) mark_unsat(c);
  }
  auto flip = [&](int v) {
    x[v] ^= 1;
    for (int c : occ[v]) {
      bool now_true = false;
      for (int l : cls[c]) if (std::abs(l) - 1 == v) { now_true = lit_true(l); break; }
      if (now_true) {
        sat_count[c]++;
        if (sat_count[c] == 1) unmark_unsat(c);
      } else {
        sat_count[c]--;
        if (sat_count[c] == 0) mark_unsat(c);
      }
    }
  };
  auto break_count = [&](int v) {
    int b = 0;
    for (int c : occ[v]) {
      if (sat_count[c] == 1) {
        // does v currently satisfy c?
        for (int l : cls[c]) {
          if (std::abs(l) - 1 == v && lit_true(l)) { b++; break; }
        }
      }
    }
    return b;
  };
  for (long long f = 0; f < max_flips; f++) {
    if (unsat.empty()) {
      for (int v = 0; v < n_vars; v++) model[v] = x[v];
      return 1;
    }
    int c = unsat[rng.below(unsat.size())];
    // pick var: freebie (break 0) or noise/random vs greedy min-break
    int best_v = -1, best_b = 1 << 30;
    for (int l : cls[c]) {
      int v = std::abs(l) - 1;
      int b = break_count(v);
      if (b == 0) { best_v = v; best_b = 0; break; }
      if (b < best_b) { best_b = b; best_v = v; }
    }
    int v;
    if (best_b == 0) v = best_v;
    else if (rng.uniform() < noise) v = std::abs(cls[c][rng.below(cls[c].size())]) - 1;
    else v = best_v;
    flip(v);
  }
  if (unsat.empty()) {
    for (int v = 0; v < n_vars; v++) model[v] = x[v];
    return 1;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TSP subtour-cut finder (replaces the reference Cython extension
// loss/tsp_subtours_cy.pyx): greedily add edges in descending predicted
// weight, merging components (union-find for symmetric TSP; Tarjan SCC for
// asymmetric), and emit violated subtour cuts (component cuts with
// predicted weight < 1) as (cut_id, flat_edge_index) pairs.

namespace {

struct UnionFind {
  std::vector<int> parent;
  explicit UnionFind(int n) : parent(n) {
    for (int i = 0; i < n; i++) parent[i] = i;
  }
  int find(int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  }
  void unite(int a, int b) { parent[find(a)] = find(b); }
};

// iterative Tarjan SCC over a dense 0/1 adjacency
void strongly_connected(const std::vector<int8_t>& adj, int n,
                        std::vector<int>& comp) {
  std::vector<int> index(n, -1), low(n, 0), stack_pos(n, 0);
  std::vector<bool> on_stack(n, false);
  std::vector<int> stk, call_node, call_child;
  comp.assign(n, -1);
  int idx = 0, n_comp = 0;
  for (int s = 0; s < n; s++) {
    if (index[s] != -1) continue;
    call_node.push_back(s);
    call_child.push_back(0);
    index[s] = low[s] = idx++;
    stk.push_back(s);
    on_stack[s] = true;
    while (!call_node.empty()) {
      int v = call_node.back();
      int& child = call_child.back();
      bool descended = false;
      while (child < n) {
        int w = child++;
        if (!adj[v * n + w]) continue;
        if (index[w] == -1) {
          index[w] = low[w] = idx++;
          stk.push_back(w);
          on_stack[w] = true;
          call_node.push_back(w);
          call_child.push_back(0);
          descended = true;
          break;
        } else if (on_stack[w]) {
          low[v] = std::min(low[v], index[w]);
        }
      }
      if (descended) continue;
      if (low[v] == index[v]) {
        for (;;) {
          int w = stk.back(); stk.pop_back();
          on_stack[w] = false;
          comp[w] = n_comp;
          if (w == v) break;
        }
        n_comp++;
      }
      call_node.pop_back();
      call_child.pop_back();
      if (!call_node.empty()) {
        int parent = call_node.back();
        low[parent] = std::min(low[parent], low[v]);
      }
    }
  }
}

}  // namespace

extern "C" {

// preds/adj: [batch, padded, padded] float32 row-major. out_pairs receives
// (cut_id, flat_index) int64 pairs; returns number of pairs written (or
// the required count if it exceeds max_pairs — caller should retry).
long long dsat_tsp_subtours(int batch, int padded, const float* preds,
                            const float* adj, float padding_value,
                            int symmetric, long long* out_pairs,
                            long long max_pairs) {
  long long written = 0;
  long long cut_id = 0;
  std::vector<int> comp(padded);
  for (int g = 0; g < batch; g++) {
    const float* P = preds + (long long)g * padded * padded;
    const float* A = adj + (long long)g * padded * padded;
    int n = padded;
    if (A[padded - 1] == padding_value) {
      n = 0;
      while (n < padded && A[n] != padding_value) n++;
    }
    if (n <= 2) continue;

    struct Edge { float w; int i, j; };
    std::vector<Edge> edges;
    edges.reserve((size_t)n * n);
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        float w = symmetric ? P[i * padded + j] + P[j * padded + i]
                            : P[i * padded + j];
        edges.push_back({w, i, j});
      }
    std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
      if (a.w != b.w) return a.w > b.w;
      if (a.i != b.i) return a.i < b.i;
      return a.j < b.j;
    });

    UnionFind uf(n);
    std::vector<int8_t> dadj;
    if (!symmetric) dadj.assign((size_t)n * n, 0);
    for (int i = 0; i < n; i++) comp[i] = i;

    auto emit_cut = [&](int target_comp, bool outgoing) {
      // cut weight in the given direction
      double w = 0;
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
          bool in_i = comp[i] == target_comp, in_j = comp[j] == target_comp;
          if (outgoing ? (in_i && !in_j) : (!in_i && in_j))
            w += P[i * padded + j];
        }
      if (w >= 1.0) return;
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
          bool in_i = comp[i] == target_comp, in_j = comp[j] == target_comp;
          if (outgoing ? (in_i && !in_j) : (!in_i && in_j)) {
            if (written < max_pairs) {
              out_pairs[2 * written] = cut_id;
              out_pairs[2 * written + 1] =
                  (long long)g * padded * padded + (long long)i * padded + j;
            }
            written++;
          }
        }
      cut_id++;
    };

    for (const Edge& e : edges) {
      if (comp[e.i] == comp[e.j]) continue;
      int edge_comp;
      if (symmetric) {
        uf.unite(e.j, e.i);
        for (int i = 0; i < n; i++) comp[i] = uf.find(i);
        edge_comp = comp[e.i];
      } else {
        dadj[e.i * n + e.j] = 1;
        strongly_connected(dadj, n, comp);
        edge_comp = comp[e.i];
      }
      bool one_component = true;
      for (int i = 0; i < n; i++)
        if (comp[i] != edge_comp) { one_component = false; break; }
      if (one_component) break;

      emit_cut(edge_comp, true);   // outgoing cut
      emit_cut(edge_comp, false);  // incoming cut
    }
  }
  return written;
}

// Exact TSP via Held-Karp bitmask DP with parent reconstruction.
// dist: [n, n] float32 row-major symmetric. out_tour: n ints (a permutation
// starting at 0). Returns the optimal tour length, or -1.0 on bad input.
// O(2^n * n^2) time, 2^(n-1)*(n-1)*(4+1) bytes: n=20 -> ~50 MB, ~0.5 s.
// Replaces the Python DP (tsp/data.py) that capped exact labels at n<=13;
// the reference labels its Euclidean TSP data Concorde-optimally at all
// sizes (reference data/tsp.py:6) — this closes the gap through n~20.
// Exact TSP by depth-first branch-and-bound with an MST lower bound
// (1-tree-lite): bound = path length + MST(unvisited) + cheapest edge
// path-end->unvisited + cheapest edge unvisited->start. Nearest-first
// child ordering makes the first DFS leaf the nearest-neighbor tour, so
// good upper bounds arrive immediately. Exact for symmetric (Euclidean)
// instances; uses min(d[i][j], d[j][i]) in the bound so mild asymmetry
// stays admissible. Practical to n ~ 30 where Held-Karp's 2^n table
// no longer fits memory. Returns the optimal length (out_tour filled,
// starting at city 0) or -1.0 when node_budget was exhausted before the
// search completed (caller should fall back to a heuristic label).
struct TspBB {
  int n;
  const float* d;
  std::vector<int> path, best_tour;
  std::vector<bool> used;
  double best = std::numeric_limits<double>::infinity();
  long long nodes = 0, budget;
  bool aborted = false;

  double w(int i, int j) const {
    float a = d[(size_t)i * n + j], b = d[(size_t)j * n + i];
    return a < b ? a : b;
  }

  double mst_bound(int last) {
    // Prim over unvisited nodes + connection edges to path-end and start
    std::vector<int> un;
    for (int j = 1; j < n; j++) if (!used[j]) un.push_back(j);
    if (un.empty()) return w(last, 0);
    int k = (int)un.size();
    std::vector<double> key(k, std::numeric_limits<double>::infinity());
    std::vector<bool> in(k, false);
    key[0] = 0.0;
    double mst = 0.0;
    for (int it = 0; it < k; it++) {
      int u = -1;
      double bestk = std::numeric_limits<double>::infinity();
      for (int i = 0; i < k; i++)
        if (!in[i] && key[i] < bestk) { bestk = key[i]; u = i; }
      if (u < 0) break;
      in[u] = true;
      mst += bestk;
      for (int i = 0; i < k; i++)
        if (!in[i]) {
          double e = w(un[u], un[i]);
          if (e < key[i]) key[i] = e;
        }
    }
    double to_un = std::numeric_limits<double>::infinity();
    double from_un = std::numeric_limits<double>::infinity();
    for (int j : un) {
      if (w(last, j) < to_un) to_un = w(last, j);
      if (w(j, 0) < from_un) from_un = w(j, 0);
    }
    return mst + to_un + from_un;
  }

  void dfs(double len) {
    if (aborted) return;
    if (++nodes > budget) { aborted = true; return; }
    int last = path.back();
    if ((int)path.size() == n) {
      double tot = len + d[(size_t)last * n + 0];
      if (tot < best) { best = tot; best_tour = path; }
      return;
    }
    if (len + mst_bound(last) >= best) return;
    std::vector<std::pair<float, int>> cand;
    for (int j = 1; j < n; j++)
      if (!used[j]) cand.push_back({d[(size_t)last * n + j], j});
    std::sort(cand.begin(), cand.end());
    for (auto& c : cand) {
      used[c.second] = true;
      path.push_back(c.second);
      dfs(len + d[(size_t)last * n + c.second]);
      path.pop_back();
      used[c.second] = false;
      if (aborted) return;
    }
  }
};

double dsat_tsp_branch_bound(int n, const float* dist, int* out_tour,
                             long long node_budget) {
  if (n < 2 || n > 64 || !dist || !out_tour) return -1.0;
  if (n == 2) {
    out_tour[0] = 0; out_tour[1] = 1;
    return (double)dist[1] + dist[2];
  }
  TspBB bb;
  bb.n = n;
  bb.d = dist;
  bb.budget = node_budget > 0 ? node_budget : (1LL << 62);
  bb.used.assign(n, false);
  bb.used[0] = true;
  bb.path.push_back(0);
  bb.dfs(0.0);
  if (bb.aborted || bb.best_tour.empty()) return -1.0;
  for (int i = 0; i < n; i++) out_tour[i] = bb.best_tour[i];
  return bb.best;
}

double dsat_tsp_held_karp(int n, const float* dist, int* out_tour) {
  if (n < 2 || n > 24 || !dist || !out_tour) return -1.0;
  if (n == 2) {
    out_tour[0] = 0; out_tour[1] = 1;
    return (double)dist[1] + dist[2 * 1];  // 0->1->0
  }
  const int m = n - 1;                  // nodes 1..n-1; node 0 is the start
  const size_t full = (size_t)1 << m;
  std::vector<float> dp(full * m, std::numeric_limits<float>::infinity());
  std::vector<uint8_t> parent(full * m, 255);
  for (int j = 0; j < m; j++)
    dp[((size_t)1 << j) * m + j] = dist[0 * n + (j + 1)];
  for (size_t mask = 1; mask < full; mask++) {
    for (int j = 0; j < m; j++) {
      if (!(mask & ((size_t)1 << j))) continue;
      float cur = dp[mask * m + j];
      if (!std::isfinite(cur)) continue;
      for (int k = 0; k < m; k++) {
        if (mask & ((size_t)1 << k)) continue;
        size_t nmask = mask | ((size_t)1 << k);
        float cand = cur + dist[(j + 1) * n + (k + 1)];
        if (cand < dp[nmask * m + k]) {
          dp[nmask * m + k] = cand;
          parent[nmask * m + k] = (uint8_t)j;
        }
      }
    }
  }
  double best = std::numeric_limits<double>::infinity();
  int best_j = -1;
  for (int j = 0; j < m; j++) {
    double cand = (double)dp[(full - 1) * m + j] + dist[(j + 1) * n + 0];
    if (cand < best) { best = cand; best_j = j; }
  }
  // reconstruct: walk parents back from best_j over the full mask
  std::vector<int> rev;
  size_t mask = full - 1;
  int j = best_j;
  while (j >= 0 && rev.size() <= (size_t)m) {
    rev.push_back(j + 1);
    uint8_t p = parent[mask * m + j];
    mask &= ~((size_t)1 << j);
    j = (p == 255) ? -1 : (int)p;
  }
  out_tour[0] = 0;
  for (int i = 0; i < m; i++) out_tour[1 + i] = rev[m - 1 - i];
  return best;
}

}  // extern "C"
