// Native batch assembler for the replay buffer (the port's copy of
// muzero_general_tpu/native/replay_sampler.cpp).
//
// Computes, for a sampled batch, the stacked observations, n-step value
// targets (with per-player sign flips, reanalysed substitution, absorbing
// states), reward/policy/action targets and gradient scales in one pass:
// the counterpart of reference replay_buffer.py get_batch/make_target/
// compute_target_value (:70-138, :230-303). Its results equal those of the
// numpy path of muzero_general_tpu_torch/replay.py bit for bit, so every
// float is rounded where numpy rounds it:
// - the bootstrap value is a float32 product, root value times
//   float32(discount ** td_steps), as numpy multiplies a float32 array by a
//   Python float;
// - the discounted rewards are float64 terms (sign * reward) * discount ** i,
//   with the powers computed by the caller as numpy computes them, zero past
//   the game's end, summed in numpy's pairwise order;
// - the action planes and the uniform policy are float64 quotients rounded
//   to float32.
// The per-game arrays are read, and their sizes checked against the game's
// length, with the interpreter lock held; the batch is then filled with it
// released, so a prefetching thread overlaps Python.
//
// Built as a CPython extension by muzero_general_tpu_torch/native/build.py
// (g++ at first use); no pybind11 dependency.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct GameView {
  const float* observations;  // [L, C, H, W]
  const int32_t* actions;     // [L+1]
  const float* rewards;       // [L+1]
  const int32_t* to_play;     // [L+1]
  const float* child_visits;  // [L, A]
  const float* root_values;   // [L] (reanalysed already substituted)
  npy_intp L;
};

// numpy's pairwise summation of n doubles (pairwise_sum_DOUBLE in numpy's
// umath loops), so that a row's sum equals np.sum(x, axis=-1) bit for bit.
double pairwise_sum(const double* a, npy_intp n) {
  if (n < 8) {
    double res = -0.0;
    for (npy_intp i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    npy_intp i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  npy_intp n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// n-step bootstrapped target value for one in-game position (replay.py
// compute_target_values; reference replay_buffer.py:230-262). disc_td =
// discount ** td_steps, disc[i] = discount ** i; terms is scratch of
// td_steps doubles.
float target_value(const GameView& g, npy_intp index, int td_steps, double disc_td,
                   const double* disc, double* terms) {
  const npy_intp L = g.L;
  float value = 0.0f;
  const npy_intp boot = index + td_steps;
  if (boot < L) {
    const float bv = g.root_values[boot];
    const float signed_bv = (g.to_play[boot] == g.to_play[index]) ? bv : -bv;
    value = signed_bv * (float)disc_td;
  }
  for (int i = 0; i < td_steps; ++i) {
    const npy_intp r_idx = index + 1 + i;
    if (r_idx > L) {
      terms[i] = 0.0;
      continue;
    }
    const npy_intp p_idx = std::min(index + i, L);
    const double sign = (g.to_play[p_idx] == g.to_play[index]) ? 1.0 : -1.0;
    terms[i] = (sign * (double)g.rewards[r_idx]) * disc[i];
  }
  return (float)((double)value + (0.0 + pairwise_sum(terms, td_steps)));
}

// Item i of `seq`: a C-contiguous array of TYPE; its data, its element
// count and its first dimension.
template <int TYPE>
bool get_array(PyObject* seq, Py_ssize_t i, const void** out, npy_intp* size, npy_intp* dim0) {
  PyArrayObject* a = (PyArrayObject*)PySequence_GetItem(seq, i);
  if (!a) return false;
  if (!PyArray_Check(a) || PyArray_TYPE(a) != TYPE || !PyArray_IS_C_CONTIGUOUS(a) ||
      PyArray_NDIM(a) < 1) {
    Py_DECREF(a);
    PyErr_SetString(PyExc_TypeError,
                    TYPE == NPY_FLOAT32 ? "expected a C-contiguous float32 array"
                                        : "expected a C-contiguous int32 array");
    return false;
  }
  *out = PyArray_DATA(a);
  *size = PyArray_SIZE(a);
  if (dim0) *dim0 = PyArray_DIM(a, 0);
  Py_DECREF(a);  // the buffer stays alive through the caller's list
  return true;
}

// A game's array holding `size` elements where its L positions need `want`,
// or a ValueError (the batch is filled without bounds checks).
bool check_game_size(npy_intp size, npy_intp want, const char* name, Py_ssize_t b) {
  if (size == want) return true;
  PyErr_Format(PyExc_ValueError, "game %zd: %s holds %zd values, its length needs %zd", b, name,
               (Py_ssize_t)size, (Py_ssize_t)want);
  return false;
}

// A C-contiguous array of `type` holding `count` elements, or a TypeError.
bool check_out(PyArrayObject* a, int type, npy_intp count, const char* name) {
  if (PyArray_TYPE(a) != type || !PyArray_IS_C_CONTIGUOUS(a) || PyArray_SIZE(a) != count) {
    PyErr_Format(PyExc_TypeError, "%s: wrong dtype, layout or size", name);
    return false;
  }
  return true;
}

// assemble_batch(obs_list, act_list, rew_list, tp_list, cv_list, rv_list,
//                positions[i32 B], random_actions[i32 B,U+1],
//                U, td_steps, disc_td, disc_powers[f64 td_steps],
//                A, n_stack, C, H, W,
//                out_obs, out_actions, out_values, out_rewards,
//                out_policies, out_grad_scale)
PyObject* assemble_batch(PyObject*, PyObject* args) {
  PyObject *obs_l, *act_l, *rew_l, *tp_l, *cv_l, *rv_l;
  PyArrayObject *positions, *rand_actions, *disc_powers;
  int U, td_steps, A, n_stack, C, H, W;
  double disc_td;
  PyArrayObject *out_obs, *out_actions, *out_values, *out_rewards, *out_policies, *out_gs;
  if (!PyArg_ParseTuple(args, "OOOOOOO!O!iidO!iiiiiO!O!O!O!O!O!", &obs_l, &act_l, &rew_l, &tp_l,
                        &cv_l, &rv_l, &PyArray_Type, &positions, &PyArray_Type, &rand_actions,
                        &U, &td_steps, &disc_td, &PyArray_Type, &disc_powers, &A, &n_stack, &C,
                        &H, &W, &PyArray_Type, &out_obs, &PyArray_Type, &out_actions,
                        &PyArray_Type, &out_values, &PyArray_Type, &out_rewards, &PyArray_Type,
                        &out_policies, &PyArray_Type, &out_gs))
    return nullptr;

  const Py_ssize_t B = PySequence_Size(obs_l);
  if (B < 0) return nullptr;
  if (U < 0 || td_steps < 0 || A <= 0 || n_stack < 0 || C <= 0 || H <= 0 || W <= 0) {
    PyErr_SetString(PyExc_ValueError, "negative or zero size");
    return nullptr;
  }
  const int UP1 = U + 1;
  const npy_intp plane = (npy_intp)H * W;
  const npy_intp obs_stride = ((npy_intp)C * (n_stack + 1) + n_stack) * plane;
  if (!check_out(positions, NPY_INT32, B, "positions") ||
      !check_out(rand_actions, NPY_INT32, B * UP1, "random_actions") ||
      !check_out(disc_powers, NPY_FLOAT64, td_steps, "disc_powers") ||
      !check_out(out_obs, NPY_FLOAT32, B * obs_stride, "out_obs") ||
      !check_out(out_actions, NPY_INT32, B * UP1, "out_actions") ||
      !check_out(out_values, NPY_FLOAT32, B * UP1, "out_values") ||
      !check_out(out_rewards, NPY_FLOAT32, B * UP1, "out_rewards") ||
      !check_out(out_policies, NPY_FLOAT32, B * UP1 * (npy_intp)A, "out_policies") ||
      !check_out(out_gs, NPY_FLOAT32, B * UP1, "out_grad_scale"))
    return nullptr;

  const int32_t* pos = (const int32_t*)PyArray_DATA(positions);
  std::vector<GameView> games(B);
  for (Py_ssize_t b = 0; b < B; ++b) {
    GameView& g = games[b];
    npy_intp n_obs, n_act, n_rew, n_tp, n_cv, n_rv;
    if (!get_array<NPY_FLOAT32>(obs_l, b, (const void**)&g.observations, &n_obs, &g.L) ||
        !get_array<NPY_INT32>(act_l, b, (const void**)&g.actions, &n_act, nullptr) ||
        !get_array<NPY_FLOAT32>(rew_l, b, (const void**)&g.rewards, &n_rew, nullptr) ||
        !get_array<NPY_INT32>(tp_l, b, (const void**)&g.to_play, &n_tp, nullptr) ||
        !get_array<NPY_FLOAT32>(cv_l, b, (const void**)&g.child_visits, &n_cv, nullptr) ||
        !get_array<NPY_FLOAT32>(rv_l, b, (const void**)&g.root_values, &n_rv, nullptr))
      return nullptr;
    const npy_intp L = g.L;
    if (!check_game_size(n_obs, L * C * plane, "observations [L, C, H, W]", b) ||
        !check_game_size(n_act, L + 1, "actions [L + 1]", b) ||
        !check_game_size(n_rew, L + 1, "rewards [L + 1]", b) ||
        !check_game_size(n_tp, L + 1, "to_play [L + 1]", b) ||
        !check_game_size(n_cv, L * A, "child_visits [L, A]", b) ||
        !check_game_size(n_rv, L, "root_values [L]", b))
      return nullptr;
    if (pos[b] < 0 || pos[b] >= g.L) {
      PyErr_SetString(PyExc_IndexError, "position outside its game");
      return nullptr;
    }
  }

  const int32_t* rnd = (const int32_t*)PyArray_DATA(rand_actions);
  const double* disc = (const double*)PyArray_DATA(disc_powers);
  float* o_obs = (float*)PyArray_DATA(out_obs);
  int32_t* o_act = (int32_t*)PyArray_DATA(out_actions);
  float* o_val = (float*)PyArray_DATA(out_values);
  float* o_rew = (float*)PyArray_DATA(out_rewards);
  float* o_pol = (float*)PyArray_DATA(out_policies);
  float* o_gs = (float*)PyArray_DATA(out_gs);
  const float uniform = (float)(1.0 / A);
  std::vector<double> terms(td_steps > 0 ? td_steps : 1);

  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t b = 0; b < B; ++b) {
    const GameView& g = games[b];
    const npy_intp p = pos[b];
    const npy_intp L = g.L;

    // ---- stacked observation (reference self_play.py:513-550) ----------
    float* dst = o_obs + b * obs_stride;
    std::copy(g.observations + p * C * plane, g.observations + (p + 1) * C * plane, dst);
    dst += (npy_intp)C * plane;
    for (int k = 1; k <= n_stack; ++k) {
      const npy_intp past = p - k;
      if (past >= 0) {
        std::copy(g.observations + past * C * plane, g.observations + (past + 1) * C * plane,
                  dst);
        dst += (npy_intp)C * plane;
        const float v = (float)((double)g.actions[past + 1] / A);
        std::fill(dst, dst + plane, v);
        dst += plane;
      } else {
        std::fill(dst, dst + (npy_intp)(C + 1) * plane, 0.0f);
        dst += (npy_intp)(C + 1) * plane;
      }
    }

    // ---- targets (reference replay_buffer.py:264-303) ------------------
    const float gs = (float)std::min((npy_intp)U, L + 1 - p);
    for (int u = 0; u < UP1; ++u) {
      const npy_intp idx = p + u;
      const npy_intp o = b * UP1 + u;
      o_gs[o] = gs;
      if (idx < L) {
        o_val[o] = target_value(g, idx, td_steps, disc_td, disc, terms.data());
        o_rew[o] = g.rewards[idx];
        std::copy(g.child_visits + idx * A, g.child_visits + (idx + 1) * A, o_pol + o * A);
        o_act[o] = g.actions[idx];
      } else if (idx == L) {
        o_val[o] = 0.0f;
        o_rew[o] = g.rewards[idx];
        std::fill(o_pol + o * A, o_pol + (o + 1) * A, uniform);
        o_act[o] = g.actions[idx];
      } else {
        o_val[o] = 0.0f;
        o_rew[o] = 0.0f;
        std::fill(o_pol + o * A, o_pol + (o + 1) * A, uniform);
        o_act[o] = rnd[o];
      }
    }
  }
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"assemble_batch", assemble_batch, METH_VARARGS, "Fill batch target arrays from sampled games."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_replay_native", nullptr, -1, methods, nullptr, nullptr, nullptr,
    nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__replay_native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
