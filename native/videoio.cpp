// Native host-side video IO runtime for meshflow.
//
// The reference reaches all its codec work through OpenCV's C++ videoio
// (cv2.VideoCapture / cv2.VideoWriter, /root/reference/meshflowstabilizer.py
// :193-196, :1310-1320).  This is the equivalent native component here:
// a libavformat/libavcodec/libswscale decoder with a
// background prefetch thread and ring buffer (decode overlaps device
// compute), plus a matching encoder.  Exposed as a C ABI consumed from
// Python via ctypes (meshflow/io/native.py).
//
// Built for the host at first use by meshflow/utils/native_build.py
// (needs libav's headers and libraries); scripts/build_native.sh does the
// same by one command.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    std::vector<uint8_t> bgr;  // h*w*3
};

constexpr size_t kRingCapacity = 256;  // frames buffered ahead of the consumer

}  // namespace

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

struct MfReader {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwsContext* sws = nullptr;
    int stream_index = -1;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    long nb_frames = 0;
    unsigned int fourcc = 0;

    // prefetch machinery
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_producer;
    std::condition_variable cv_consumer;
    std::deque<Frame> ring;
    std::atomic<bool> eof{false};
    std::atomic<bool> stop{false};
    std::string error;

    ~MfReader() {
        stop.store(true);
        cv_producer.notify_all();
        if (worker.joinable()) worker.join();
        if (sws) sws_freeContext(sws);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }

    void decode_loop() {
        AVPacket* pkt = av_packet_alloc();
        AVFrame* frame = av_frame_alloc();

        std::vector<uint8_t> bgr_plane(static_cast<size_t>(width) * height * 3);
        uint8_t* dst_data[4] = {bgr_plane.data(), nullptr, nullptr, nullptr};
        int dst_linesize[4] = {width * 3, 0, 0, 0};

        auto emit = [&](AVFrame* f) {
            sws_scale(sws, f->data, f->linesize, 0, height, dst_data,
                      dst_linesize);
            Frame item;
            item.bgr.assign(bgr_plane.begin(), bgr_plane.end());
            std::unique_lock<std::mutex> lock(mu);
            cv_producer.wait(lock, [&] {
                return ring.size() < kRingCapacity || stop.load();
            });
            if (stop.load()) return false;
            ring.push_back(std::move(item));
            cv_consumer.notify_one();
            return true;
        };

        bool draining = false;
        while (!stop.load()) {
            if (!draining) {
                int r = av_read_frame(fmt, pkt);
                if (r < 0) {
                    avcodec_send_packet(dec, nullptr);  // flush
                    draining = true;
                } else {
                    if (pkt->stream_index == stream_index) {
                        avcodec_send_packet(dec, pkt);
                    }
                    av_packet_unref(pkt);
                }
            }
            while (true) {
                int r = avcodec_receive_frame(dec, frame);
                if (r == AVERROR(EAGAIN)) break;
                if (r == AVERROR_EOF || r < 0) {
                    goto done;
                }
                if (!emit(frame)) goto done;
                av_frame_unref(frame);
            }
        }
    done:
        av_frame_free(&frame);
        av_packet_free(&pkt);
        eof.store(true);
        cv_consumer.notify_all();
    }
};

extern "C" MfReader* mf_reader_open(const char* path) {
    auto* r = new MfReader();
    if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
        delete r;
        return nullptr;
    }
    if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
        delete r;
        return nullptr;
    }
    const AVCodec* codec = nullptr;
    r->stream_index =
        av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (r->stream_index < 0 || codec == nullptr) {
        delete r;
        return nullptr;
    }
    AVStream* stream = r->fmt->streams[r->stream_index];
    r->dec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(r->dec, stream->codecpar);
    r->dec->thread_count = 0;  // auto
    if (avcodec_open2(r->dec, codec, nullptr) < 0) {
        delete r;
        return nullptr;
    }
    r->width = r->dec->width;
    r->height = r->dec->height;
    AVRational fr = stream->avg_frame_rate.num
                        ? stream->avg_frame_rate
                        : stream->r_frame_rate;
    r->fps = fr.den ? static_cast<double>(fr.num) / fr.den : 0.0;
    r->nb_frames = stream->nb_frames;
    if (r->nb_frames == 0 && stream->duration > 0 && fr.den) {
        r->nb_frames = static_cast<long>(
            av_rescale_q(stream->duration, stream->time_base,
                         AVRational{fr.den, fr.num}));
    }
    r->fourcc = stream->codecpar->codec_tag;
    r->sws = sws_getContext(r->width, r->height, r->dec->pix_fmt, r->width,
                            r->height, AV_PIX_FMT_BGR24, SWS_BILINEAR,
                            nullptr, nullptr, nullptr);
    if (!r->sws) {
        delete r;
        return nullptr;
    }
    r->worker = std::thread([r] { r->decode_loop(); });
    return r;
}

extern "C" void mf_reader_info(MfReader* r, int* w, int* h, double* fps,
                               long* nb_frames, unsigned int* fourcc) {
    *w = r->width;
    *h = r->height;
    *fps = r->fps;
    *nb_frames = r->nb_frames;
    *fourcc = r->fourcc;
}

// Copy up to max_frames decoded BGR frames into out (max_frames*h*w*3).
// Blocks until at least one frame is available or the stream ends.
// Returns the number of frames written (0 => end of stream).
extern "C" long mf_reader_read(MfReader* r, uint8_t* out, long max_frames) {
    const size_t frame_bytes =
        static_cast<size_t>(r->width) * r->height * 3;
    long produced = 0;
    while (produced < max_frames) {
        std::unique_lock<std::mutex> lock(r->mu);
        r->cv_consumer.wait(lock, [&] {
            return !r->ring.empty() || r->eof.load();
        });
        if (r->ring.empty()) break;  // eof
        while (!r->ring.empty() && produced < max_frames) {
            Frame f = std::move(r->ring.front());
            r->ring.pop_front();
            std::memcpy(out + produced * frame_bytes, f.bgr.data(),
                        frame_bytes);
            ++produced;
        }
        r->cv_producer.notify_one();
    }
    return produced;
}

extern "C" void mf_reader_close(MfReader* r) { delete r; }

// ---------------------------------------------------------------------------
// Writer
// ---------------------------------------------------------------------------

struct MfWriter {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    AVStream* stream = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* yuv = nullptr;
    int width = 0;
    int height = 0;
    long pts = 0;
    bool ok = false;
};

extern "C" MfWriter* mf_writer_open(const char* path, int w, int h,
                                    double fps, unsigned int fourcc) {
    auto* wr = new MfWriter();
    wr->width = w;
    wr->height = h;
    if (avformat_alloc_output_context2(&wr->fmt, nullptr, nullptr, path) < 0 ||
        !wr->fmt) {
        delete wr;
        return nullptr;
    }
    // Prefer the codec implied by the requested fourcc; fall back to mpeg4
    // (always built into libavcodec) the way io.video falls back to mp4v.
    const AVCodec* codec = nullptr;
    if (fourcc) {
        const AVCodecTag* mov_tags[2] = {avformat_get_mov_video_tags(),
                                         nullptr};
        const AVCodecTag* const* tags = wr->fmt->oformat->codec_tag
                                            ? wr->fmt->oformat->codec_tag
                                            : mov_tags;
        enum AVCodecID want = av_codec_get_id(tags, fourcc);
        if (want != AV_CODEC_ID_NONE) codec = avcodec_find_encoder(want);
    }
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
    if (!codec) {
        delete wr;
        return nullptr;
    }
    wr->stream = avformat_new_stream(wr->fmt, codec);
    wr->enc = avcodec_alloc_context3(codec);
    wr->enc->width = w;
    wr->enc->height = h;
    wr->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    wr->enc->thread_count = 0;  // auto (matches the decoder; 1 core = 1)
    AVRational tb = av_d2q(1.0 / (fps > 0 ? fps : 30.0), 100000);
    wr->enc->time_base = tb;
    wr->stream->time_base = tb;
    // Declare the nominal rate; otherwise probers estimate fps as
    // nb_frames/duration, which is off by one interval on short clips.
    AVRational rate = av_d2q(fps > 0 ? fps : 30.0, 100000);
    wr->enc->framerate = rate;
    wr->stream->avg_frame_rate = rate;
    wr->stream->r_frame_rate = rate;
    wr->enc->bit_rate = static_cast<int64_t>(0.2 * w * h * (fps > 0 ? fps : 30));
    if (wr->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        wr->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(wr->enc, codec, nullptr) < 0) {
        delete wr;
        return nullptr;
    }
    avcodec_parameters_from_context(wr->stream->codecpar, wr->enc);
    wr->sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h,
                             AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                             nullptr, nullptr);
    wr->yuv = av_frame_alloc();
    wr->yuv->format = AV_PIX_FMT_YUV420P;
    wr->yuv->width = w;
    wr->yuv->height = h;
    av_frame_get_buffer(wr->yuv, 0);
    if (!(wr->fmt->oformat->flags & AVFMT_NOFILE)) {
        if (avio_open(&wr->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
            delete wr;
            return nullptr;
        }
    }
    if (avformat_write_header(wr->fmt, nullptr) < 0) {
        delete wr;
        return nullptr;
    }
    wr->ok = true;
    return wr;
}

static int mf_writer_flush(MfWriter* wr, AVFrame* frame) {
    if (avcodec_send_frame(wr->enc, frame) < 0) return -1;
    AVPacket* pkt = av_packet_alloc();
    while (true) {
        int r = avcodec_receive_packet(wr->enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) {
            av_packet_free(&pkt);
            return -1;
        }
        av_packet_rescale_ts(pkt, wr->enc->time_base, wr->stream->time_base);
        pkt->stream_index = wr->stream->index;
        av_interleaved_write_frame(wr->fmt, pkt);
        av_packet_unref(pkt);
    }
    av_packet_free(&pkt);
    return 0;
}

extern "C" long mf_writer_write(MfWriter* wr, const uint8_t* frames, long n) {
    const uint8_t* src_data[4] = {nullptr, nullptr, nullptr, nullptr};
    int src_linesize[4] = {wr->width * 3, 0, 0, 0};
    for (long i = 0; i < n; ++i) {
        src_data[0] = frames + static_cast<size_t>(i) * wr->width * wr->height * 3;
        av_frame_make_writable(wr->yuv);
        sws_scale(wr->sws, src_data, src_linesize, 0, wr->height,
                  wr->yuv->data, wr->yuv->linesize);
        wr->yuv->pts = wr->pts++;
        if (mf_writer_flush(wr, wr->yuv) < 0) return i;
    }
    return n;
}

extern "C" int mf_writer_close(MfWriter* wr) {
    int rc = 0;
    if (wr->ok) {
        mf_writer_flush(wr, nullptr);  // drain encoder
        rc = av_write_trailer(wr->fmt);
    }
    if (wr->yuv) av_frame_free(&wr->yuv);
    if (wr->sws) sws_freeContext(wr->sws);
    if (wr->enc) avcodec_free_context(&wr->enc);
    if (wr->fmt) {
        if (!(wr->fmt->oformat->flags & AVFMT_NOFILE) && wr->fmt->pb)
            avio_closep(&wr->fmt->pb);
        avformat_free_context(wr->fmt);
    }
    delete wr;
    return rc;
}
