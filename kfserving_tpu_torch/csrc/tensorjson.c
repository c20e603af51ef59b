/* tensorjson: dense-tensor JSON codec for the V1 request path.
 *
 * Port of the JAX package's csrc/tensorjson.c, unchanged in behaviour: a
 * V1 predict body is parsed straight into a contiguous buffer in one pass
 * (no intermediate PyObject per element), and prediction tensors are
 * serialized back without building Python lists.  It is a CPython
 * extension, built at first use by kfserving_tpu_torch/csrc/build.py
 * (build_extension) with the host C compiler against the interpreter's
 * Python.h, and loaded by kfserving_tpu_torch/protocol/native.py, which
 * also holds the pure-Python fallback with identical eligibility rules.
 *
 * Exposed functions:
 *   parse_v1(body: bytes, hint: str = None)
 *       -> (data: bytes, shape: tuple, key: str, dtype: str, extra: int)
 *       Parses {"instances": <dense array>} or {"inputs": ...}.
 *       `extra` is 1 when the body carried other top-level keys
 *       (parameters, signature_name, ...) -- the caller must fall back
 *       to a full decode so those keys reach the model unchanged.
 *       hint="u1" (from the served model's declared input_dtype) emits
 *       a uint8 buffer directly when every value is integral in
 *       [0, 255]: the image-intake path skips the int32 intermediate
 *       and the per-batch astype copy.
 *       Raises ValueError on ragged/non-numeric arrays or other JSON
 *       (the caller falls back to json.loads for those).
 *   dump_f32(data: bytes, shape: tuple) -> bytes
 *       Serializes a float32 tensor as a nested JSON array.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_DEPTH 8

typedef struct {
    const char *p;
    const char *end;
    /* growable output (doubles; cast to f32/i32 on emit) */
    double *data;
    size_t len;
    size_t cap;
    /* shape discovery: dims[d] fixed by the first completed sibling */
    Py_ssize_t dims[MAX_DEPTH];
    int ndim;            /* set when the first leaf array completes */
    int all_int;         /* every value integral and within int32 */
    int all_u8;          /* every value integral and within [0, 255] */
} Parser;

static int
grow(Parser *ps, size_t need)
{
    if (ps->len + need <= ps->cap)
        return 0;
    size_t ncap = ps->cap ? ps->cap * 2 : 1024;
    while (ncap < ps->len + need)
        ncap *= 2;
    double *nd = realloc(ps->data, ncap * sizeof(double));
    if (nd == NULL)
        return -1;
    ps->data = nd;
    ps->cap = ncap;
    return 0;
}

static void
skip_ws(Parser *ps)
{
    while (ps->p < ps->end) {
        char c = *ps->p;
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r')
            ps->p++;
        else
            break;
    }
}

/* Skip any JSON value (used for keys we don't extract). Returns 0 ok. */
static int
skip_value(Parser *ps, int depth)
{
    if (depth > 64)
        return -1;
    skip_ws(ps);
    if (ps->p >= ps->end)
        return -1;
    char c = *ps->p;
    if (c == '"') {
        ps->p++;
        while (ps->p < ps->end) {
            if (*ps->p == '\\')
                ps->p += 2;
            else if (*ps->p == '"') {
                ps->p++;
                return 0;
            }
            else
                ps->p++;
        }
        return -1;
    }
    if (c == '{' || c == '[') {
        char close = (c == '{') ? '}' : ']';
        ps->p++;
        skip_ws(ps);
        if (ps->p < ps->end && *ps->p == close) {
            ps->p++;
            return 0;
        }
        for (;;) {
            if (c == '{') {
                if (skip_value(ps, depth + 1) < 0)  /* key */
                    return -1;
                skip_ws(ps);
                if (ps->p >= ps->end || *ps->p != ':')
                    return -1;
                ps->p++;
            }
            if (skip_value(ps, depth + 1) < 0)
                return -1;
            skip_ws(ps);
            if (ps->p >= ps->end)
                return -1;
            if (*ps->p == ',') {
                ps->p++;
                continue;
            }
            if (*ps->p == close) {
                ps->p++;
                return 0;
            }
            return -1;
        }
    }
    /* number / true / false / null */
    while (ps->p < ps->end) {
        c = *ps->p;
        if (c == ',' || c == ']' || c == '}' || c == ' ' || c == '\n' ||
            c == '\t' || c == '\r')
            break;
        ps->p++;
    }
    return 0;
}

/* Parse a dense numeric array at depth d; verifies rectangular shape. */
static int
parse_dense(Parser *ps, int d)
{
    skip_ws(ps);
    if (ps->p >= ps->end || *ps->p != '[' || d >= MAX_DEPTH)
        return -1;
    ps->p++;
    Py_ssize_t count = 0;
    skip_ws(ps);
    if (ps->p < ps->end && *ps->p == ']') {
        ps->p++;
        /* empty array only legal as an empty leaf */
        if (ps->ndim == 0)
            ps->ndim = d + 1;
        if (ps->dims[d] == -1)
            ps->dims[d] = 0;
        return ps->dims[d] == 0 ? 0 : -1;
    }
    for (;;) {
        skip_ws(ps);
        if (ps->p >= ps->end)
            return -1;
        if (*ps->p == '[') {
            if (parse_dense(ps, d + 1) < 0)
                return -1;
        }
        else {
            /* leaf number.  Fast path: plain integers (the dominant
             * case for uint8 image tensors) parse with a digit loop —
             * strtod costs ~10x per token and its absence also skips
             * the float-demotion re-scan.  Anything with '.', an
             * exponent, or >15 digits falls back to strtod. */
            double v;
            const char *q = ps->p;
            int neg = 0;
            if (q < ps->end && *q == '-') { neg = 1; q++; }
            const char *dstart = q;
            long long iv = 0;
            while (q < ps->end && *q >= '0' && *q <= '9' &&
                   q - dstart < 15) {
                iv = iv * 10 + (*q - '0');
                q++;
            }
            if (q > dstart && (q >= ps->end ||
                               (*q != '.' && *q != 'e' && *q != 'E' &&
                                (*q < '0' || *q > '9')))) {
                v = neg ? -(double)iv : (double)iv;
                ps->p = q;
                if (ps->all_int &&
                    (v < -2147483648.0 || v > 2147483647.0))
                    ps->all_int = 0;
                if (ps->all_u8 && (neg || iv > 255))
                    ps->all_u8 = 0;
            }
            else {
                char *endptr;
                v = strtod(ps->p, &endptr);
                if (endptr == ps->p)
                    return -1;      /* not a number (string/null/...) */
                ps->p = endptr;
                /* slow-path tokens are float-looking or huge: demote */
                ps->all_int = 0;
                ps->all_u8 = 0;
            }
            if (ps->ndim == 0)
                ps->ndim = d + 1;   /* leaves live at this depth */
            else if (ps->ndim != d + 1)
                return -1;          /* ragged nesting */
            if (grow(ps, 1) < 0)
                return -1;
            ps->data[ps->len++] = v;
        }
        count++;
        skip_ws(ps);
        if (ps->p >= ps->end)
            return -1;
        if (*ps->p == ',') {
            ps->p++;
            continue;
        }
        if (*ps->p == ']') {
            ps->p++;
            break;
        }
        return -1;
    }
    if (ps->dims[d] == -1)
        ps->dims[d] = count;
    else if (ps->dims[d] != count)
        return -1;                  /* ragged */
    return 0;
}

static PyObject *
py_parse_v1(PyObject *self, PyObject *args)
{
    PyObject *arg;
    const char *hint = NULL;   /* "u1": emit uint8 when values fit */
    if (!PyArg_ParseTuple(args, "O|z", &arg, &hint))
        return NULL;
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    Parser ps;
    memset(&ps, 0, sizeof(ps));
    ps.p = (const char *)view.buf;
    ps.end = ps.p + view.len;
    ps.all_int = 1;
    ps.all_u8 = 1;
    for (int i = 0; i < MAX_DEPTH; i++)
        ps.dims[i] = -1;

    const char *key = NULL;
    int extra = 0;   /* any top-level key besides the tensor key */
    skip_ws(&ps);
    if (ps.p >= ps.end || *ps.p != '{')
        goto fail;
    ps.p++;
    for (;;) {
        skip_ws(&ps);
        if (ps.p >= ps.end)
            goto fail;
        if (*ps.p == '}') {
            ps.p++;
            break;
        }
        if (*ps.p != '"')
            goto fail;
        /* read key */
        const char *kstart = ++ps.p;
        while (ps.p < ps.end && *ps.p != '"') {
            if (*ps.p == '\\')
                goto fail;          /* escaped keys: fall back */
            ps.p++;
        }
        if (ps.p >= ps.end)
            goto fail;
        size_t klen = (size_t)(ps.p - kstart);
        ps.p++;
        skip_ws(&ps);
        if (ps.p >= ps.end || *ps.p != ':')
            goto fail;
        ps.p++;
        if (key == NULL &&
            ((klen == 9 && memcmp(kstart, "instances", 9) == 0) ||
             (klen == 6 && memcmp(kstart, "inputs", 6) == 0))) {
            key = (klen == 9) ? "instances" : "inputs";
            if (parse_dense(&ps, 0) < 0)
                goto fail;
        }
        else {
            extra = 1;
            if (skip_value(&ps, 0) < 0)
                goto fail;
        }
        skip_ws(&ps);
        if (ps.p < ps.end && *ps.p == ',') {
            ps.p++;
            continue;
        }
    }
    skip_ws(&ps);
    if (ps.p != ps.end || key == NULL || ps.ndim == 0)
        goto fail;

    {
        PyObject *shape = PyTuple_New(ps.ndim);
        if (shape == NULL)
            goto fail;
        for (int i = 0; i < ps.ndim; i++)
            PyTuple_SET_ITEM(shape, i,
                             PyLong_FromSsize_t(ps.dims[i] < 0 ? 0
                                                               : ps.dims[i]));
        /* Emit uint8 when the caller asked for it AND every token fits
         * (the image-intake fast path: the batch reaches the engine in
         * wire dtype, no int32 intermediate or astype copy).  The hint
         * comes from the served model's declared input_dtype — never
         * from value range alone, which would flip dtypes per request
         * and churn the engine's compiled signatures.  Otherwise:
         * int32 when integral (class labels / token ids round-trip as
         * ints), float32 else. */
        int emit_u8 = (hint != NULL && strcmp(hint, "u1") == 0 &&
                       ps.all_u8);
        const char *dtype = emit_u8 ? "u1" : (ps.all_int ? "i4" : "f4");
        PyObject *bytes = PyBytes_FromStringAndSize(
            NULL, (Py_ssize_t)(ps.len * (emit_u8 ? 1 : 4)));
        if (bytes != NULL) {
            char *dst = PyBytes_AS_STRING(bytes);
            if (emit_u8) {
                uint8_t *out8 = (uint8_t *)dst;
                for (size_t i = 0; i < ps.len; i++)
                    out8[i] = (uint8_t)ps.data[i];
            }
            else if (ps.all_int) {
                int32_t *out32 = (int32_t *)dst;
                for (size_t i = 0; i < ps.len; i++)
                    out32[i] = (int32_t)ps.data[i];
            }
            else {
                float *outf = (float *)dst;
                for (size_t i = 0; i < ps.len; i++)
                    outf[i] = (float)ps.data[i];
            }
        }
        free(ps.data);
        PyBuffer_Release(&view);
        if (bytes == NULL) {
            Py_DECREF(shape);
            return NULL;
        }
        PyObject *out = Py_BuildValue("(NNssi)", bytes, shape, key, dtype,
                                      extra);
        return out;
    }

fail:
    free(ps.data);
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError,
                    "not a dense numeric V1 body");
    return NULL;
}

/* ---- serialization ---------------------------------------------------- */

typedef struct {
    char *buf;
    size_t len;
    size_t cap;
} Writer;

static int
wgrow(Writer *w, size_t need)
{
    if (w->len + need <= w->cap)
        return 0;
    size_t ncap = w->cap ? w->cap * 2 : 4096;
    while (ncap < w->len + need)
        ncap *= 2;
    char *nb = realloc(w->buf, ncap);
    if (nb == NULL)
        return -1;
    w->buf = nb;
    w->cap = ncap;
    return 0;
}

static int
write_level(Writer *w, const float *data, const Py_ssize_t *dims,
            int ndim, int d, size_t *offset)
{
    if (wgrow(w, 1) < 0)
        return -1;
    w->buf[w->len++] = '[';
    for (Py_ssize_t i = 0; i < dims[d]; i++) {
        if (i > 0) {
            if (wgrow(w, 1) < 0)
                return -1;
            w->buf[w->len++] = ',';
        }
        if (d == ndim - 1) {
            if (wgrow(w, 32) < 0)
                return -1;
            double v = (double)data[(*offset)++];
            if (!isfinite(v)) {
                /* json.dumps parity: Python accepts only these spellings */
                const char *tok = isnan(v) ? "NaN"
                                : (v > 0) ? "Infinity" : "-Infinity";
                w->len += (size_t)snprintf(w->buf + w->len, 32, "%s", tok);
            }
            /* range guard BEFORE the (long long) cast: casting a double
             * outside long long range is undefined behavior */
            else if (v > -1e15 && v < 1e15 &&
                     v == (double)(long long)v) {
                w->len += (size_t)snprintf(w->buf + w->len, 32, "%lld.0",
                                           (long long)v);
            }
            else {
                /* %.9g: float32 needs 9 significant digits to round-trip */
                w->len += (size_t)snprintf(w->buf + w->len, 32, "%.9g", v);
            }
        }
        else {
            if (write_level(w, data, dims, ndim, d + 1, offset) < 0)
                return -1;
        }
    }
    if (wgrow(w, 1) < 0)
        return -1;
    w->buf[w->len++] = ']';
    return 0;
}

static PyObject *
py_dump_f32(PyObject *self, PyObject *args)
{
    Py_buffer view;
    PyObject *shape;
    if (!PyArg_ParseTuple(args, "y*O!", &view, &PyTuple_Type, &shape))
        return NULL;
    int ndim = (int)PyTuple_GET_SIZE(shape);
    if (ndim < 1 || ndim > MAX_DEPTH) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bad ndim");
        return NULL;
    }
    Py_ssize_t dims[MAX_DEPTH];
    Py_ssize_t total = 1;
    for (int i = 0; i < ndim; i++) {
        dims[i] = PyLong_AsSsize_t(PyTuple_GET_ITEM(shape, i));
        if (dims[i] < 0) {
            PyBuffer_Release(&view);
            PyErr_SetString(PyExc_ValueError, "bad shape");
            return NULL;
        }
        total *= dims[i];
    }
    if ((size_t)total * sizeof(float) != (size_t)view.len) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "shape/data mismatch");
        return NULL;
    }
    Writer w;
    memset(&w, 0, sizeof(w));
    size_t offset = 0;
    int rc = write_level(&w, (const float *)view.buf, dims, ndim, 0,
                         &offset);
    PyBuffer_Release(&view);
    if (rc < 0) {
        free(w.buf);
        return PyErr_NoMemory();
    }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, (Py_ssize_t)w.len);
    free(w.buf);
    return out;
}

static PyMethodDef methods[] = {
    {"parse_v1", py_parse_v1, METH_VARARGS,
     "parse_v1(body, hint=None): parse a dense V1 predict body into "
     "(bytes, shape, key, dtype, extra); hint='u1' emits uint8 when "
     "every value is integral in [0, 255]."},
    {"dump_f32", py_dump_f32, METH_VARARGS,
     "Serialize a float32 tensor as a nested JSON array (bytes)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tensorjson",
    "Dense-tensor JSON codec for the V1 request path.", -1, methods,
};

PyMODINIT_FUNC
PyInit__tensorjson(void)
{
    return PyModule_Create(&moduledef);
}
