/* In-repo LV2 fixture plugin library — this environment ships no
 * system LV2 bundles, so the host tests (and the dynamically
 * registered lv2 elements) load these, the csrc/ladspa_plugins.c
 * approach applied to the LV2 core ABI (lv2core/lv2.h as published;
 * the struct layout is re-declared here rather than #included).
 *
 * Plugins:
 *   urn:gstbad:lv2:amp     mono filter: gain * (invert ? -1 : 1),
 *                          float/toggled/integer controls + a peak
 *                          output control port
 *   urn:gstbad:lv2:width   stereo filter via port-groups: mid/side
 *                          width scaling
 *   urn:gstbad:lv2:sine    source: amplitude * sin(2*pi*freq*t),
 *                          phase persists across run(), activate()
 *                          resets it
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef void *LV2_Handle;

typedef struct {
  const char *URI;
  void *data;
} LV2_Feature;

typedef struct _LV2_Descriptor {
  const char *URI;
  LV2_Handle (*instantiate) (const struct _LV2_Descriptor *,
      double sample_rate, const char *bundle_path,
      const LV2_Feature * const *features);
  void (*connect_port) (LV2_Handle, uint32_t port, void *data);
  void (*activate) (LV2_Handle);
  void (*run) (LV2_Handle, uint32_t n_samples);
  void (*deactivate) (LV2_Handle);
  void (*cleanup) (LV2_Handle);
  const void *(*extension_data) (const char *uri);
} LV2_Descriptor;

/* ---------------------------------------------------------- amp */

typedef struct {
  const float *in;
  float *out;
  const float *gain;       /* control in 2 */
  const float *invert;     /* control in 3 (toggled) */
  const float *offset;     /* control in 4 (integer) */
  float *peak;             /* control out 5 */
} Amp;

static LV2_Handle
amp_instantiate (const LV2_Descriptor * d, double rate,
    const char *bundle, const LV2_Feature * const *features)
{
  (void) d; (void) rate; (void) bundle; (void) features;
  return calloc (1, sizeof (Amp));
}

static void
amp_connect (LV2_Handle h, uint32_t port, void *data)
{
  Amp *a = (Amp *) h;
  switch (port) {
    case 0: a->in = (const float *) data; break;
    case 1: a->out = (float *) data; break;
    case 2: a->gain = (const float *) data; break;
    case 3: a->invert = (const float *) data; break;
    case 4: a->offset = (const float *) data; break;
    case 5: a->peak = (float *) data; break;
  }
}

static void
amp_run (LV2_Handle h, uint32_t n)
{
  Amp *a = (Amp *) h;
  const float g = (a->gain ? *a->gain : 1.0f)
      * ((a->invert && *a->invert > 0.0f) ? -1.0f : 1.0f);
  const float off = a->offset ? (float) (int) *a->offset : 0.0f;
  float peak = 0.0f;
  for (uint32_t i = 0; i < n; i++) {
    const float v = a->in[i] * g + off * 1e-3f;
    a->out[i] = v;
    const float m = fabsf (v);
    if (m > peak)
      peak = m;
  }
  if (a->peak)
    *a->peak = peak;
}

static void
gen_cleanup (LV2_Handle h)
{
  free (h);
}

/* ---------------------------------------------------------- width */

typedef struct {
  const float *in_l, *in_r;
  float *out_l, *out_r;
  const float *width;
} Width;

static LV2_Handle
width_instantiate (const LV2_Descriptor * d, double rate,
    const char *bundle, const LV2_Feature * const *features)
{
  (void) d; (void) rate; (void) bundle; (void) features;
  return calloc (1, sizeof (Width));
}

static void
width_connect (LV2_Handle h, uint32_t port, void *data)
{
  Width *w = (Width *) h;
  switch (port) {
    case 0: w->in_l = (const float *) data; break;
    case 1: w->in_r = (const float *) data; break;
    case 2: w->out_l = (float *) data; break;
    case 3: w->out_r = (float *) data; break;
    case 4: w->width = (const float *) data; break;
  }
}

static void
width_run (LV2_Handle h, uint32_t n)
{
  Width *w = (Width *) h;
  const float k = w->width ? *w->width : 1.0f;
  for (uint32_t i = 0; i < n; i++) {
    const float mid = 0.5f * (w->in_l[i] + w->in_r[i]);
    const float side = 0.5f * (w->in_l[i] - w->in_r[i]) * k;
    w->out_l[i] = mid + side;
    w->out_r[i] = mid - side;
  }
}

/* ---------------------------------------------------------- sine */

typedef struct {
  float *out;
  const float *freq;
  const float *amp;
  double rate;
  double phase;
} Sine;

static LV2_Handle
sine_instantiate (const LV2_Descriptor * d, double rate,
    const char *bundle, const LV2_Feature * const *features)
{
  (void) d; (void) bundle; (void) features;
  Sine *s = calloc (1, sizeof (Sine));
  s->rate = rate;
  return s;
}

static void
sine_connect (LV2_Handle h, uint32_t port, void *data)
{
  Sine *s = (Sine *) h;
  switch (port) {
    case 0: s->out = (float *) data; break;
    case 1: s->freq = (const float *) data; break;
    case 2: s->amp = (const float *) data; break;
  }
}

static void
sine_activate (LV2_Handle h)
{
  ((Sine *) h)->phase = 0.0;
}

static void
sine_run (LV2_Handle h, uint32_t n)
{
  Sine *s = (Sine *) h;
  const double f = s->freq ? (double) *s->freq : 440.0;
  const double a = s->amp ? (double) *s->amp : 1.0;
  const double step = 2.0 * M_PI * f / s->rate;
  for (uint32_t i = 0; i < n; i++) {
    s->out[i] = (float) (a * sin (s->phase));
    s->phase += step;
  }
  s->phase = fmod (s->phase, 2.0 * M_PI);
}

/* ------------------------------------------------- statefilter
 * Exercises the LV2 State extension: a 4-tap gain table and a tag
 * string live OUTSIDE the control ports and are saved/restored
 * through LV2_State_Interface (state/state.h) using host-mapped
 * URIDs (urid/urid.h). */

typedef uint32_t (*urid_map_fn) (void *, const char *);
typedef struct { void *handle; urid_map_fn map; } URID_Map;

typedef int32_t (*state_store_fn) (void *, uint32_t, const void *,
    size_t, uint32_t, uint32_t);
typedef const void *(*state_retrieve_fn) (void *, uint32_t, size_t *,
    uint32_t *, uint32_t *);
typedef struct {
  int32_t (*save) (LV2_Handle, state_store_fn, void *, uint32_t,
      const LV2_Feature * const *);
  int32_t (*restore) (LV2_Handle, state_retrieve_fn, void *, uint32_t,
      const LV2_Feature * const *);
} State_Interface;

typedef struct {
  const float *in;
  float *out;
  float table[4];
  char tag[16];
  uint32_t urid_table, urid_tag, urid_chunk, urid_string;
} StateFilter;

static LV2_Handle
sf_instantiate (const LV2_Descriptor * d, double rate,
    const char *bundle, const LV2_Feature * const *features)
{
  (void) d; (void) rate; (void) bundle;
  StateFilter *s = calloc (1, sizeof (StateFilter));
  for (int i = 0; i < 4; i++)
    s->table[i] = 1.0f;
  strcpy (s->tag, "default");
  if (features) {
    for (const LV2_Feature * const *f = features; *f; f++) {
      if (!strcmp ((*f)->URI, "http://lv2plug.in/ns/ext/urid#map")) {
        URID_Map *m = (URID_Map *) (*f)->data;
        s->urid_table = m->map (m->handle,
            "urn:gstbad:lv2:statefilter#table");
        s->urid_tag = m->map (m->handle,
            "urn:gstbad:lv2:statefilter#tag");
        s->urid_chunk = m->map (m->handle,
            "http://lv2plug.in/ns/ext/atom#Chunk");
        s->urid_string = m->map (m->handle,
            "http://lv2plug.in/ns/ext/atom#String");
      }
    }
  }
  return s;
}

static void
sf_connect (LV2_Handle h, uint32_t port, void *data)
{
  StateFilter *s = (StateFilter *) h;
  switch (port) {
    case 0: s->in = (const float *) data; break;
    case 1: s->out = (float *) data; break;
  }
}

static void
sf_run (LV2_Handle h, uint32_t n)
{
  StateFilter *s = (StateFilter *) h;
  for (uint32_t i = 0; i < n; i++)
    s->out[i] = s->in[i] * s->table[i & 3];
}

static int32_t
sf_save (LV2_Handle h, state_store_fn store, void *sh, uint32_t flags,
    const LV2_Feature * const *features)
{
  StateFilter *s = (StateFilter *) h;
  (void) flags; (void) features;
  store (sh, s->urid_table, s->table, sizeof (s->table),
      s->urid_chunk, 3 /* POD|PORTABLE */);
  store (sh, s->urid_tag, s->tag, strlen (s->tag) + 1,
      s->urid_string, 3);
  return 0;
}

static int32_t
sf_restore (LV2_Handle h, state_retrieve_fn retrieve, void *sh,
    uint32_t flags, const LV2_Feature * const *features)
{
  StateFilter *s = (StateFilter *) h;
  size_t size = 0;
  uint32_t type = 0, f = 0;
  (void) flags; (void) features;
  const void *v = retrieve (sh, s->urid_table, &size, &type, &f);
  if (v && size == sizeof (s->table) && type == s->urid_chunk)
    memcpy (s->table, v, sizeof (s->table));
  v = retrieve (sh, s->urid_tag, &size, &type, &f);
  if (v && size > 0 && size <= sizeof (s->tag)
      && type == s->urid_string) {
    memcpy (s->tag, v, size);
    s->tag[sizeof (s->tag) - 1] = 0;
  }
  return 0;
}

static const State_Interface sf_state_iface = { sf_save, sf_restore };

static const void *
sf_extension_data (const char *uri)
{
  if (!strcmp (uri, "http://lv2plug.in/ns/ext/state#interface"))
    return &sf_state_iface;
  return NULL;
}

/* ---------------------------------------------------------- table */

static const LV2_Descriptor descriptors[] = {
  {"urn:gstbad:lv2:amp", amp_instantiate, amp_connect, NULL,
      amp_run, NULL, gen_cleanup, NULL},
  {"urn:gstbad:lv2:width", width_instantiate, width_connect, NULL,
      width_run, NULL, gen_cleanup, NULL},
  {"urn:gstbad:lv2:sine", sine_instantiate, sine_connect,
      sine_activate, sine_run, NULL, gen_cleanup, NULL},
  {"urn:gstbad:lv2:statefilter", sf_instantiate, sf_connect, NULL,
      sf_run, NULL, gen_cleanup, sf_extension_data},
};

const LV2_Descriptor *
lv2_descriptor (uint32_t index)
{
  if (index >= sizeof (descriptors) / sizeof (descriptors[0]))
    return NULL;
  return &descriptors[index];
}
