// rtvqa_io — native host I/O runtime for the video-analysis framework.
//
// Replaces every external process/bindings dependency of the reference:
//   * cv2.VideoCapture decode loops (reference complexity_metrics.py:51,89,520
//     — which decode the clip THREE times per run, SURVEY.md §2.4(3)): here one
//     single decode pass yields sampled frames + timestamps together.
//   * the `ffmpeg -c:v libx264 -crf N` encode subprocess
//     (reference video_processing.py:200-214): in-process libx264 encode.
//   * the `ffprobe -show_entries stream=...` subprocess + eval() hazard
//     (reference video_processing.py:101-142, SURVEY.md §2.4(7)): in-process
//     stream probing with exact rational fps.
//
// Exposed as a C ABI consumed from Python via ctypes (rtvqa_tpu/io/video.py).
// Frames are returned as planar YUV (native codec layout; no host-side color
// conversion — RGB/gray conversion happens on the device) or as interleaved RGB24
// via libswscale when byte-parity with cv2's BGR decode path is wanted.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#define RTVQA_API extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

int fail(const std::string& msg) {
  set_error(msg);
  return -1;
}

struct DecodedVideo {
  int width = 0;
  int height = 0;
  int64_t bit_rate = 0;       // bits per second (container/stream metadata)
  double avg_fps = 0.0;       // exact rational avg_frame_rate
  int64_t n_frames_total = 0; // frames actually decoded
  int64_t n_sampled = 0;      // frames kept (every `interval`-th, 1-based)
  // Planar YUV420 storage, one contiguous block per plane across frames.
  std::vector<uint8_t> y, u, v;
  std::vector<double> timestamps_ms; // per *sampled* frame
  int chroma_w = 0, chroma_h = 0;
};

// Open + fully decode one video stream, keeping every `interval`-th frame
// (1-based counting: frames 1..N, keep when count % interval == 0 — the
// reference's read_frame_pairs semantics at complexity_metrics.py:103-104;
// timestamps come from the SAME pass, fixing the off-by-one divergence of
// extract_frame_timestamps, SURVEY.md §2.4(4)).
int decode_impl(const char* path, int interval, int threads, DecodedVideo* out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
    return fail(std::string("cannot open input: ") + path);
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return fail("cannot find stream info");
  }
  int vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vstream < 0) {
    avformat_close_input(&fmt);
    return fail("no video stream");
  }
  AVStream* st = fmt->streams[vstream];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) {
    avformat_close_input(&fmt);
    return fail("unsupported codec");
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(ctx, st->codecpar);
  ctx->thread_count = threads;  // 0 = auto; config num_workers plumbs here
  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return fail("cannot open codec");
  }

  out->width = ctx->width;
  out->height = ctx->height;
  out->bit_rate = st->codecpar->bit_rate ? st->codecpar->bit_rate : fmt->bit_rate;
  if (st->avg_frame_rate.den > 0)
    out->avg_fps = av_q2d(st->avg_frame_rate);
  out->chroma_w = (ctx->width + 1) / 2;
  out->chroma_h = (ctx->height + 1) / 2;

  SwsContext* to420 = nullptr;  // convert decoder pix_fmt -> yuv420p if needed
  AVFrame* frame = av_frame_alloc();
  AVFrame* f420 = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();

  const size_t ysz = (size_t)ctx->width * ctx->height;
  const size_t csz = (size_t)out->chroma_w * out->chroma_h;
  double tb = av_q2d(st->time_base) * 1000.0;  // -> milliseconds
  int64_t count = 0;
  int ret = 0;
  bool draining = false;

  auto keep_frame = [&](AVFrame* f) -> int {
    AVFrame* src = f;
    if (f->format != AV_PIX_FMT_YUV420P && f->format != AV_PIX_FMT_YUVJ420P) {
      if (!to420) {
        to420 = sws_getContext(ctx->width, ctx->height, (AVPixelFormat)f->format,
                               ctx->width, ctx->height, AV_PIX_FMT_YUV420P,
                               SWS_BILINEAR, nullptr, nullptr, nullptr);
        if (!to420) return fail("sws_getContext failed");
        f420->format = AV_PIX_FMT_YUV420P;
        f420->width = ctx->width;
        f420->height = ctx->height;
        if (av_frame_get_buffer(f420, 32) < 0) return fail("frame alloc failed");
      }
      sws_scale(to420, f->data, f->linesize, 0, ctx->height, f420->data, f420->linesize);
      src = f420;
    }
    size_t base_y = out->y.size();
    out->y.resize(base_y + ysz);
    for (int r = 0; r < ctx->height; ++r)
      memcpy(out->y.data() + base_y + (size_t)r * ctx->width,
             src->data[0] + (size_t)r * src->linesize[0], ctx->width);
    size_t base_c = out->u.size();
    out->u.resize(base_c + csz);
    out->v.resize(base_c + csz);
    for (int r = 0; r < out->chroma_h; ++r) {
      memcpy(out->u.data() + base_c + (size_t)r * out->chroma_w,
             src->data[1] + (size_t)r * src->linesize[1], out->chroma_w);
      memcpy(out->v.data() + base_c + (size_t)r * out->chroma_w,
             src->data[2] + (size_t)r * src->linesize[2], out->chroma_w);
    }
    int64_t pts = f->best_effort_timestamp;
    out->timestamps_ms.push_back(pts == AV_NOPTS_VALUE ? 0.0 : pts * tb);
    out->n_sampled++;
    return 0;
  };

  while (true) {
    if (!draining) {
      ret = av_read_frame(fmt, pkt);
      if (ret < 0) {
        draining = true;
        avcodec_send_packet(ctx, nullptr);
      } else if (pkt->stream_index != vstream) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(ctx, pkt);
        av_packet_unref(pkt);
      }
    }
    while (true) {
      ret = avcodec_receive_frame(ctx, frame);
      if (ret == AVERROR(EAGAIN)) break;
      if (ret == AVERROR_EOF) goto done;
      if (ret < 0) { fail("decode error"); goto done; }
      count++;
      if (count % interval == 0) {
        if (keep_frame(frame) < 0) { av_frame_unref(frame); goto done; }
      }
      av_frame_unref(frame);
    }
    if (draining && ret == AVERROR(EAGAIN)) break;  // defensive
  }
done:
  out->n_frames_total = count;
  if (to420) sws_freeContext(to420);
  av_frame_free(&f420);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  return (out->n_sampled >= 0 && g_last_error.empty()) ? 0 : -1;
}

}  // namespace

RTVQA_API const char* rtvqa_last_error() { return g_last_error.c_str(); }

RTVQA_API void* rtvqa_decode_open_threads(const char* path, int frame_interval,
                                          int threads);

// ---------------------------------------------------------------------------
// Decode API (opaque handle; two-phase so Python can allocate numpy buffers).
// ---------------------------------------------------------------------------

RTVQA_API void* rtvqa_decode_open(const char* path, int frame_interval) {
  return rtvqa_decode_open_threads(path, frame_interval, 0);
}

RTVQA_API void* rtvqa_decode_open_threads(const char* path, int frame_interval,
                                          int threads) {
  g_last_error.clear();
  auto* dv = new DecodedVideo();
  if (decode_impl(path, frame_interval < 1 ? 1 : frame_interval, threads, dv) < 0) {
    delete dv;
    return nullptr;
  }
  return dv;
}

RTVQA_API int rtvqa_decode_info(void* handle, int64_t* out_info) {
  // out_info: [n_sampled, width, height, chroma_w, chroma_h, n_frames_total,
  //            bit_rate, fps_milli]
  auto* dv = static_cast<DecodedVideo*>(handle);
  if (!dv) return -1;
  out_info[0] = dv->n_sampled;
  out_info[1] = dv->width;
  out_info[2] = dv->height;
  out_info[3] = dv->chroma_w;
  out_info[4] = dv->chroma_h;
  out_info[5] = dv->n_frames_total;
  out_info[6] = dv->bit_rate;
  out_info[7] = (int64_t)(dv->avg_fps * 1000.0 + 0.5);
  return 0;
}

RTVQA_API int rtvqa_decode_copy(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                                double* timestamps_ms) {
  auto* dv = static_cast<DecodedVideo*>(handle);
  if (!dv) return -1;
  memcpy(y, dv->y.data(), dv->y.size());
  memcpy(u, dv->u.data(), dv->u.size());
  memcpy(v, dv->v.data(), dv->v.size());
  memcpy(timestamps_ms, dv->timestamps_ms.data(),
         dv->timestamps_ms.size() * sizeof(double));
  return 0;
}

RTVQA_API void rtvqa_decode_close(void* handle) {
  delete static_cast<DecodedVideo*>(handle);
}

// ---------------------------------------------------------------------------
// Streaming decode API — iterator over sampled-frame batches with bounded
// memory (the whole-clip API above is fine for short clips; long 1080p
// full-frame quality analysis streams through this one). The Python side
// wraps it in a double-buffered prefetch thread so host decode overlaps
// device compute.
// ---------------------------------------------------------------------------

namespace {

struct StreamState {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  SwsContext* to420 = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* f420 = nullptr;
  AVPacket* pkt = nullptr;
  int vstream = -1;
  int interval = 1;
  int64_t count = 0;
  bool draining = false;
  bool done = false;
  double tb_ms = 0.0;
  int chroma_w = 0, chroma_h = 0;
};

}  // namespace

RTVQA_API void* rtvqa_stream_open(const char* path, int frame_interval) {
  g_last_error.clear();
  auto* st = new StreamState();
  st->interval = frame_interval < 1 ? 1 : frame_interval;
  if (avformat_open_input(&st->fmt, path, nullptr, nullptr) < 0) {
    set_error(std::string("cannot open input: ") + path);
    delete st;
    return nullptr;
  }
  if (avformat_find_stream_info(st->fmt, nullptr) < 0 ||
      (st->vstream = av_find_best_stream(st->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                         nullptr, 0)) < 0) {
    set_error("no usable video stream");
    avformat_close_input(&st->fmt);
    delete st;
    return nullptr;
  }
  AVStream* vs = st->fmt->streams[st->vstream];
  const AVCodec* codec = avcodec_find_decoder(vs->codecpar->codec_id);
  st->ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(st->ctx, vs->codecpar);
  st->ctx->thread_count = 0;
  if (!codec || avcodec_open2(st->ctx, codec, nullptr) < 0) {
    set_error("cannot open codec");
    avcodec_free_context(&st->ctx);
    avformat_close_input(&st->fmt);
    delete st;
    return nullptr;
  }
  st->tb_ms = av_q2d(vs->time_base) * 1000.0;
  st->chroma_w = (st->ctx->width + 1) / 2;
  st->chroma_h = (st->ctx->height + 1) / 2;
  st->frame = av_frame_alloc();
  st->f420 = av_frame_alloc();
  st->pkt = av_packet_alloc();
  return st;
}

RTVQA_API int rtvqa_stream_info(void* handle, int64_t* out_info) {
  // [width, height, chroma_w, chroma_h, bit_rate, fps_milli]
  auto* st = static_cast<StreamState*>(handle);
  if (!st) return -1;
  AVStream* vs = st->fmt->streams[st->vstream];
  out_info[0] = st->ctx->width;
  out_info[1] = st->ctx->height;
  out_info[2] = st->chroma_w;
  out_info[3] = st->chroma_h;
  out_info[4] = vs->codecpar->bit_rate ? vs->codecpar->bit_rate : st->fmt->bit_rate;
  double fps = vs->avg_frame_rate.den > 0 ? av_q2d(vs->avg_frame_rate) : 0.0;
  out_info[5] = (int64_t)(fps * 1000.0 + 0.5);
  return 0;
}

// Fill up to max_frames sampled frames; returns the number delivered
// (0 = EOF, <0 = error).
RTVQA_API int rtvqa_stream_next(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                                double* timestamps_ms, int max_frames) {
  auto* st = static_cast<StreamState*>(handle);
  if (!st || st->done) return st && st->done ? 0 : -1;
  const int w = st->ctx->width, h = st->ctx->height;
  const size_t ysz = (size_t)w * h;
  const size_t csz = (size_t)st->chroma_w * st->chroma_h;
  int delivered = 0;

  auto emit = [&](AVFrame* f) {
    AVFrame* src = f;
    if (f->format != AV_PIX_FMT_YUV420P && f->format != AV_PIX_FMT_YUVJ420P) {
      if (!st->to420) {
        st->to420 = sws_getContext(w, h, (AVPixelFormat)f->format, w, h,
                                   AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
        st->f420->format = AV_PIX_FMT_YUV420P;
        st->f420->width = w;
        st->f420->height = h;
        av_frame_get_buffer(st->f420, 32);
      }
      sws_scale(st->to420, f->data, f->linesize, 0, h, st->f420->data,
                st->f420->linesize);
      src = st->f420;
    }
    uint8_t* yd = y + (size_t)delivered * ysz;
    for (int r = 0; r < h; ++r)
      memcpy(yd + (size_t)r * w, src->data[0] + (size_t)r * src->linesize[0], w);
    uint8_t* ud = u + (size_t)delivered * csz;
    uint8_t* vd = v + (size_t)delivered * csz;
    for (int r = 0; r < st->chroma_h; ++r) {
      memcpy(ud + (size_t)r * st->chroma_w,
             src->data[1] + (size_t)r * src->linesize[1], st->chroma_w);
      memcpy(vd + (size_t)r * st->chroma_w,
             src->data[2] + (size_t)r * src->linesize[2], st->chroma_w);
    }
    int64_t pts = f->best_effort_timestamp;
    timestamps_ms[delivered] = pts == AV_NOPTS_VALUE ? 0.0 : pts * st->tb_ms;
    delivered++;
  };

  while (delivered < max_frames) {
    int ret = avcodec_receive_frame(st->ctx, st->frame);
    if (ret == 0) {
      st->count++;
      if (st->count % st->interval == 0) emit(st->frame);
      av_frame_unref(st->frame);
      continue;
    }
    if (ret == AVERROR_EOF) {
      st->done = true;
      break;
    }
    if (ret != AVERROR(EAGAIN)) return fail("decode error");
    if (st->draining) {  // defensive: EAGAIN after flush ⇒ treat as EOF
      st->done = true;
      break;
    }
    ret = av_read_frame(st->fmt, st->pkt);
    if (ret < 0) {
      st->draining = true;
      avcodec_send_packet(st->ctx, nullptr);
    } else if (st->pkt->stream_index != st->vstream) {
      av_packet_unref(st->pkt);
    } else {
      avcodec_send_packet(st->ctx, st->pkt);
      av_packet_unref(st->pkt);
    }
  }
  return delivered;
}

RTVQA_API void rtvqa_stream_close(void* handle) {
  auto* st = static_cast<StreamState*>(handle);
  if (!st) return;
  if (st->to420) sws_freeContext(st->to420);
  av_frame_free(&st->frame);
  av_frame_free(&st->f420);
  av_packet_free(&st->pkt);
  avcodec_free_context(&st->ctx);
  avformat_close_input(&st->fmt);
  delete st;
}

// ---------------------------------------------------------------------------
// Probe API — replaces the ffprobe subprocess (video_processing.py:101-142).
// ---------------------------------------------------------------------------

RTVQA_API int rtvqa_probe(const char* path, int64_t* out_info) {
  // out_info: [width, height, bit_rate_bps, fps_num, fps_den, n_frames_meta]
  g_last_error.clear();
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
    return fail(std::string("cannot open input: ") + path);
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return fail("cannot find stream info");
  }
  int vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vstream < 0) {
    avformat_close_input(&fmt);
    return fail("no video stream");
  }
  AVStream* st = fmt->streams[vstream];
  out_info[0] = st->codecpar->width;
  out_info[1] = st->codecpar->height;
  out_info[2] = st->codecpar->bit_rate ? st->codecpar->bit_rate : fmt->bit_rate;
  out_info[3] = st->avg_frame_rate.num;
  out_info[4] = st->avg_frame_rate.den;
  out_info[5] = st->nb_frames;
  avformat_close_input(&fmt);
  return 0;
}

// ---------------------------------------------------------------------------
// Encode API — replaces the `ffmpeg -c:v libx264 -crf N -preset medium`
// subprocess (video_processing.py:200-214). Transcodes input -> H.264 mp4.
// ---------------------------------------------------------------------------

namespace {

struct Encoder {
  AVFormatContext* ofmt = nullptr;
  AVCodecContext* enc = nullptr;
  AVStream* ost = nullptr;
  AVPacket* pkt = nullptr;
  int64_t next_pts = 0;
  bool header_written = false;

  int open(const char* path, int w, int h, AVRational fps, int crf,
           const char* preset) {
    const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) return fail("libx264 encoder unavailable");
    if (avformat_alloc_output_context2(&ofmt, nullptr, nullptr, path) < 0)
      return fail("cannot allocate output context");
    enc = avcodec_alloc_context3(codec);
    enc->width = w;
    enc->height = h;
    enc->pix_fmt = AV_PIX_FMT_YUV420P;
    enc->time_base = av_inv_q(fps);
    enc->framerate = fps;
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    // Pin x264 to one deterministic thread: with threads=auto the encoded
    // bitstream varies run-to-run (observed: same input + settings, pixel
    // maxdiff ~90 across processes), which breaks reproducible sweeps and
    // the sharded-vs-sequential row-equality guarantee. One core is all
    // this host has anyway; thread_count=1 also disables the lookahead
    // threads x264 derives from it.
    enc->thread_count = 1;
    av_opt_set(enc->priv_data, "preset", preset, 0);
    av_opt_set_double(enc->priv_data, "crf", crf, 0);
    // mbtree OFF by default: this build's mbtree lookahead produces
    // heap-layout-dependent bitstreams (bisect: mbtree=0 or rc-lookahead=0
    // stable; threads=1, zeroed input padding, FP-env reset, CFR durations
    // all insufficient), i.e. encodes were not a pure function of the
    // pixels. Deterministic encodes are a framework guarantee (same clip
    // twice -> bit-identical CSV row); the rate-allocation difference is a
    // documented divergence (docs/PARITY.md). Override with
    // RTVQA_X264_PARAMS=mbtree=1 to restore x264 defaults.
    av_opt_set(enc->priv_data, "x264-params", "mbtree=0", 0);
    if (const char* xp = getenv("RTVQA_X264_PARAMS"))
      av_opt_set(enc->priv_data, "x264-params", xp, 0);
    if (avcodec_open2(enc, codec, nullptr) < 0) return fail("cannot open libx264");
    ost = avformat_new_stream(ofmt, nullptr);
    ost->time_base = enc->time_base;
    ost->avg_frame_rate = fps;
    ost->r_frame_rate = fps;
    avcodec_parameters_from_context(ost->codecpar, enc);
    if (!(ofmt->oformat->flags & AVFMT_NOFILE))
      if (avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0)
        return fail("cannot open output file");
    if (avformat_write_header(ofmt, nullptr) < 0)
      return fail("cannot write header");
    header_written = true;
    pkt = av_packet_alloc();
    return 0;
  }

  int drain() {
    while (true) {
      int ret = avcodec_receive_packet(enc, pkt);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
      if (ret < 0) return fail("encode error");
      av_packet_rescale_ts(pkt, enc->time_base, ost->time_base);
      pkt->stream_index = ost->index;
      if (av_interleaved_write_frame(ofmt, pkt) < 0)
        return fail("write frame failed");
    }
  }

  int push(AVFrame* f) {
    if (!f) {
      if (avcodec_send_frame(enc, nullptr) < 0) return fail("send frame failed");
      return drain();
    }
    // Deep-copy the frame into a freshly allocated, fully ZEROED buffer
    // before handing it to libx264. Decoder/pool frames carry unzeroed
    // stride + allocation padding; x264's vectorized plane copy / lookahead
    // overreads row tails into that padding, making the encoded bitstream
    // depend on heap garbage (observed: same input + settings produced
    // pixel-level different outputs whenever unrelated allocations ran in
    // between, and across processes). Zeroed padding makes the encode a
    // pure function of the pixels. Cost: one memset+memcpy per frame —
    // noise next to the encode itself.
    AVFrame* c = av_frame_alloc();
    if (!c) return fail("oom");
    c->format = f->format;
    c->width = f->width;
    c->height = f->height;
    if (av_frame_get_buffer(c, 64) < 0) {
      av_frame_free(&c);
      return fail("frame buffer alloc failed");
    }
    for (int i = 0; c->buf[i]; ++i)
      memset(c->buf[i]->data, 0, c->buf[i]->size);
    av_frame_copy(c, f);
    av_frame_copy_props(c, f);
    c->pts = next_pts++;
    c->pkt_duration = 1;  // one tick of enc->time_base (= 1/fps): CFR input
    int rc = avcodec_send_frame(enc, c) < 0 ? fail("send frame failed") : drain();
    av_frame_free(&c);
    return rc;
  }

  int close() {
    int rc = 0;
    // Only flush/trailer when the header was written: av_write_trailer on a
    // never-initialized muxer (e.g. open failed on a bad path) crashes.
    if (enc && header_written) rc = push(nullptr);
    if (ofmt && header_written) av_write_trailer(ofmt);
    if (pkt) av_packet_free(&pkt);
    if (enc) avcodec_free_context(&enc);
    if (ofmt) {
      if (!(ofmt->oformat->flags & AVFMT_NOFILE) && ofmt->pb) avio_closep(&ofmt->pb);
      avformat_free_context(ofmt);
      ofmt = nullptr;
    }
    return rc;
  }
};

}  // namespace

// Transcode `in_path` to H.264 at the given CRF/preset (decode -> encode).
RTVQA_API int rtvqa_transcode(const char* in_path, const char* out_path, int crf,
                              const char* preset) {
  g_last_error.clear();
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, in_path, nullptr, nullptr) < 0)
    return fail(std::string("cannot open input: ") + in_path);
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return fail("cannot find stream info");
  }
  int vstream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vstream < 0) {
    avformat_close_input(&fmt);
    return fail("no video stream");
  }
  AVStream* st = fmt->streams[vstream];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, st->codecpar);
  dec->thread_count = 0;
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return fail("cannot open decoder");
  }

  AVRational fps = st->avg_frame_rate.den > 0 ? st->avg_frame_rate
                                              : AVRational{30, 1};
  Encoder e;
  if (e.open(out_path, dec->width, dec->height, fps, crf, preset) < 0) {
    e.close();
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }

  SwsContext* to420 = nullptr;
  AVFrame* frame = av_frame_alloc();
  AVFrame* f420 = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  int rc = 0;
  bool draining = false;
  while (rc == 0) {
    int ret;
    if (!draining) {
      ret = av_read_frame(fmt, pkt);
      if (ret < 0) {
        draining = true;
        avcodec_send_packet(dec, nullptr);
      } else if (pkt->stream_index != vstream) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(dec, pkt);
        av_packet_unref(pkt);
      }
    }
    bool eof = false;
    while (true) {
      ret = avcodec_receive_frame(dec, frame);
      if (ret == AVERROR(EAGAIN)) break;
      if (ret == AVERROR_EOF) { eof = true; break; }
      if (ret < 0) { rc = fail("decode error"); break; }
      AVFrame* src = frame;
      if (frame->format != AV_PIX_FMT_YUV420P) {
        if (!to420) {
          to420 = sws_getContext(dec->width, dec->height,
                                 (AVPixelFormat)frame->format, dec->width,
                                 dec->height, AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                                 nullptr, nullptr, nullptr);
          f420->format = AV_PIX_FMT_YUV420P;
          f420->width = dec->width;
          f420->height = dec->height;
          av_frame_get_buffer(f420, 32);
        }
        sws_scale(to420, frame->data, frame->linesize, 0, dec->height,
                  f420->data, f420->linesize);
        src = f420;
      }
      rc = e.push(src);
      av_frame_unref(frame);
      if (rc < 0) break;
    }
    if (eof) break;
  }
  int crc = e.close();
  if (rc == 0) rc = crc;
  if (to420) sws_freeContext(to420);
  av_frame_free(&f420);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return rc;
}

// Encode raw YUV420 frames (contiguous planar, n frames) to H.264 mp4.
// Used by tests to synthesize clips without any external tool.
RTVQA_API int rtvqa_encode_raw(const char* out_path, const uint8_t* y,
                               const uint8_t* u, const uint8_t* v, int n,
                               int w, int h, int fps_num, int fps_den, int crf,
                               const char* preset) {
  g_last_error.clear();
  Encoder e;
  if (e.open(out_path, w, h, AVRational{fps_num, fps_den}, crf, preset) < 0) {
    e.close();
    return -1;
  }
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  AVFrame* f = av_frame_alloc();
  f->format = AV_PIX_FMT_YUV420P;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 32);
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i) {
    av_frame_make_writable(f);
    for (int r = 0; r < h; ++r)
      memcpy(f->data[0] + (size_t)r * f->linesize[0],
             y + (size_t)i * w * h + (size_t)r * w, w);
    for (int r = 0; r < ch; ++r) {
      memcpy(f->data[1] + (size_t)r * f->linesize[1],
             u + (size_t)i * cw * ch + (size_t)r * cw, cw);
      memcpy(f->data[2] + (size_t)r * f->linesize[2],
             v + (size_t)i * cw * ch + (size_t)r * cw, cw);
    }
    rc = e.push(f);
  }
  int crc = e.close();
  av_frame_free(&f);
  return rc == 0 ? crc : rc;
}
