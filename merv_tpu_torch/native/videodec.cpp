// Native video decoder: the decord-equivalent C++ data-loader component.
//
// Role parity with the reference's decord dependency (C++ FFmpeg wrapper used
// for all video decode + frame sampling, reference
// merv/preprocessing/datasets/datasets.py:125-156): indexed frame access,
// get_batch(frame_ids), avg_fps — plus one capability decord lacks:
// *fused decode+resize* (sws_scale straight to the target resolution), so the
// dataloader's per-frame cv2.resize disappears from the host hot path.
//
// C ABI (consumed via ctypes from merv_tpu/native/__init__.py):
//   vr_open(path)                       -> handle (0 on failure)
//   vr_num_frames(h) / vr_fps(h)        -> stream metadata
//   vr_width(h) / vr_height(h)
//   vr_get_batch(h, ids, n, out)        -> native-size RGB24 frames
//   vr_get_batch_resized(h, ids, n, w, h, bilinear, out)
//   vr_close(h)
//   vr_last_error(h)                    -> static error string
//
// Thread safety: one reader per handle; concurrent handles are independent
// (dataloader workers each open their own).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  const AVStream* stream = nullptr;
  int stream_idx = -1;
  AVFrame* frame = nullptr;
  AVFrame* last_good = nullptr;  // most recent decoded frame (EOF clamp)
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  int sws_w = -1, sws_h = -1, sws_flags = -1;
  int64_t n_frames = 0;
  double fps = 0.0;
  // decode cursor: index of the next frame the decoder will emit (-1 unknown)
  int64_t cursor = -1;
  std::string error;

  ~Reader() {
    if (sws) sws_freeContext(sws);
    if (pkt) av_packet_free(&pkt);
    if (last_good) av_frame_free(&last_good);
    if (frame) av_frame_free(&frame);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }
};

int64_t pts_to_index(const Reader* r, int64_t pts) {
  if (pts == AV_NOPTS_VALUE) return -1;
  const AVRational tb = r->stream->time_base;
  const double start =
      r->stream->start_time == AV_NOPTS_VALUE ? 0.0 : r->stream->start_time * av_q2d(tb);
  return llround((pts * av_q2d(tb) - start) * r->fps);
}

// Decode forward until the frame with index >= target is produced.
// Returns 0 on success with the frame in r->frame.
int decode_until(Reader* r, int64_t target) {
  while (true) {
    int ret = avcodec_receive_frame(r->codec, r->frame);
    if (ret == 0) {
      int64_t idx = pts_to_index(r, r->frame->best_effort_timestamp);
      if (idx < 0) idx = r->cursor;  // streams without pts: trust the cursor
      r->cursor = idx + 1;
      // remember every decoded frame: containers whose nb_frames metadata
      // over-counts the decodable frames (codec delay, truncated tails)
      // then clamp index requests past the end to the LAST real frame
      // (decord's sampling semantics) instead of failing the whole batch
      av_frame_unref(r->last_good);
      av_frame_ref(r->last_good, r->frame);
      if (idx >= target) return 0;
      av_frame_unref(r->frame);
      continue;
    }
    if (ret == AVERROR(EAGAIN)) {
      // feed more packets
      while (true) {
        ret = av_read_frame(r->fmt, r->pkt);
        if (ret < 0) {
          avcodec_send_packet(r->codec, nullptr);  // flush
          break;
        }
        if (r->pkt->stream_index == r->stream_idx) {
          ret = avcodec_send_packet(r->codec, r->pkt);
          av_packet_unref(r->pkt);
          if (ret < 0 && ret != AVERROR(EAGAIN)) {
            r->error = "send_packet failed";
            return -1;
          }
          break;
        }
        av_packet_unref(r->pkt);
      }
      continue;
    }
    if (ret == AVERROR_EOF) {
      // target past end: clamp to the most recent decoded frame if any
      if (!r->frame->data[0] && r->last_good && r->last_good->data[0]) {
        av_frame_unref(r->frame);
        av_frame_move_ref(r->frame, r->last_good);
      }
      r->error = "eof before target frame";
      return r->frame->data[0] ? 1 : -1;
    }
    r->error = "receive_frame failed";
    return -1;
  }
}

int seek_to(Reader* r, int64_t target) {
  const AVRational tb = r->stream->time_base;
  const double start =
      r->stream->start_time == AV_NOPTS_VALUE ? 0.0 : r->stream->start_time * av_q2d(tb);
  int64_t ts = llround((target / r->fps + start) / av_q2d(tb));
  if (av_seek_frame(r->fmt, r->stream_idx, ts, AVSEEK_FLAG_BACKWARD) < 0) {
    // fall back to byte-0 seek
    if (av_seek_frame(r->fmt, r->stream_idx, 0, AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE) < 0) {
      r->error = "seek failed";
      return -1;
    }
  }
  avcodec_flush_buffers(r->codec);
  av_frame_unref(r->last_good);  // pre-seek frames must not serve as EOF clamp
  r->cursor = -1;  // unknown until the next frame's pts tells us
  return 0;
}

int convert_frame(Reader* r, int out_w, int out_h, int flags, uint8_t* dst) {
  if (!r->sws || r->sws_w != out_w || r->sws_h != out_h || r->sws_flags != flags) {
    if (r->sws) sws_freeContext(r->sws);
    r->sws = sws_getContext(r->codec->width, r->codec->height,
                            (AVPixelFormat)r->frame->format, out_w, out_h,
                            AV_PIX_FMT_RGB24, flags, nullptr, nullptr, nullptr);
    r->sws_w = out_w;
    r->sws_h = out_h;
    r->sws_flags = flags;
  }
  if (!r->sws) {
    r->error = "sws_getContext failed";
    return -1;
  }
  uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
  int dst_linesize[4] = {out_w * 3, 0, 0, 0};
  sws_scale(r->sws, r->frame->data, r->frame->linesize, 0, r->codec->height, dst_data,
            dst_linesize);
  return 0;
}

// Decode a sorted-unique id plan; invoke convert for each wanted frame.
int fetch(Reader* r, const int64_t* ids, int n, int out_w, int out_h, int flags, uint8_t* out) {
  const size_t frame_bytes = (size_t)out_w * out_h * 3;
  // map: wanted index -> list of output slots (handles duplicate ids)
  std::vector<std::pair<int64_t, int>> plan(n);
  for (int i = 0; i < n; ++i) plan[i] = {ids[i], i};
  std::sort(plan.begin(), plan.end());

  const int64_t SEEK_AHEAD = 64;  // decode-forward window before preferring a seek
  int64_t last_done = -2;
  for (int i = 0; i < n; ++i) {
    int64_t target = plan[i].first;
    uint8_t* dst = out + frame_bytes * plan[i].second;
    if (target == last_done) {  // duplicate id: copy previous conversion
      if (convert_frame(r, out_w, out_h, flags, dst) != 0) return -1;
      continue;
    }
    if (r->cursor < 0 || target < r->cursor - 1 || target > r->cursor + SEEK_AHEAD) {
      if (seek_to(r, target) != 0) return -1;
    }
    int rc = decode_until(r, target);
    if (rc < 0) return -1;
    if (convert_frame(r, out_w, out_h, flags, dst) != 0) return -1;
    last_done = target;
  }
  return 0;
}

}  // namespace

extern "C" {

void* vr_open(const char* path) {
  av_log_set_level(AV_LOG_ERROR);
  Reader* r = new Reader();
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  r->stream_idx = av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (r->stream_idx < 0) {
    delete r;
    return nullptr;
  }
  r->stream = r->fmt->streams[r->stream_idx];
  const AVCodec* dec = avcodec_find_decoder(r->stream->codecpar->codec_id);
  if (!dec) {
    delete r;
    return nullptr;
  }
  r->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(r->codec, r->stream->codecpar);
  r->codec->thread_count = 0;  // auto
  if (avcodec_open2(r->codec, dec, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  r->frame = av_frame_alloc();
  r->last_good = av_frame_alloc();
  r->pkt = av_packet_alloc();

  AVRational fr = av_guess_frame_rate(r->fmt, const_cast<AVStream*>(r->stream), nullptr);
  r->fps = (fr.num > 0 && fr.den > 0) ? av_q2d(fr) : 30.0;
  r->n_frames = r->stream->nb_frames;
  if (r->n_frames <= 0) {
    double dur = 0.0;
    if (r->stream->duration != AV_NOPTS_VALUE)
      dur = r->stream->duration * av_q2d(r->stream->time_base);
    else if (r->fmt->duration != AV_NOPTS_VALUE)
      dur = (double)r->fmt->duration / AV_TIME_BASE;
    r->n_frames = (int64_t)(dur * r->fps);
  }
  if (r->n_frames <= 0) r->n_frames = 1;
  return r;
}

int64_t vr_num_frames(void* h) { return static_cast<Reader*>(h)->n_frames; }
double vr_fps(void* h) { return static_cast<Reader*>(h)->fps; }
int vr_width(void* h) { return static_cast<Reader*>(h)->codec->width; }
int vr_height(void* h) { return static_cast<Reader*>(h)->codec->height; }
const char* vr_last_error(void* h) { return static_cast<Reader*>(h)->error.c_str(); }

int vr_get_batch(void* h, const int64_t* ids, int n, uint8_t* out) {
  Reader* r = static_cast<Reader*>(h);
  return fetch(r, ids, n, r->codec->width, r->codec->height, SWS_BILINEAR, out);
}

int vr_get_batch_resized(void* h, const int64_t* ids, int n, int out_w, int out_h, int bicubic,
                         uint8_t* out) {
  Reader* r = static_cast<Reader*>(h);
  return fetch(r, ids, n, out_w, out_h, bicubic ? SWS_BICUBIC : SWS_BILINEAR, out);
}

void vr_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
