// Build-validation stub of the ALE C++ API surface consumed by AleBackend
// (env_engine.cpp HAVE_ALE section, mirroring tf_atari.cpp:24-128).
//
// This is NOT the Arcade Learning Environment. It implements just enough of
// ale_interface.hpp's API — same names, same shapes — to (a) compile the
// HAVE_ALE code path in CI without the GPL-licensed ALE checkout the
// reference requires (atari/README.md:10-16), and (b) smoke-run it: the
// "game" is a deterministic counter world with 3 lives, scripted rewards and
// a game-over horizon, so reset/noop/FIRE/frameskip/RAM/lives plumbing can
// be exercised end to end.
//
// Building against the REAL ALE (recipe, matching the reference's):
//   git clone https://github.com/mgbellemare/Arcade-Learning-Environment
//   cmake -DBUILD_SHARED_LIBS=ON && make && make install  (prefix $ALE)
//   NEVO_ALE_PREFIX=$ALE python -m deep_neuroevolution_torch.native.build
// then AtariEnv("frostbite", rom_path=...) drives real ROMs. The port's own
// copy of the JAX package's stub (native/ale_stub/ale_interface.hpp there).
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace ale {

using Action = int;
constexpr Action PLAYER_A_NOOP = 0;
constexpr Action PLAYER_A_FIRE = 1;

namespace stub {
constexpr int H = 210, W = 160, RAM_SIZE = 128;
constexpr int FRAMES_PER_LIFE = 40;   // emulator frames until a life is lost
constexpr int LIVES = 3;
}  // namespace stub

class ALERAM {
 public:
  explicit ALERAM(const uint8_t* bytes) : bytes_(bytes) {}
  size_t size() const { return stub::RAM_SIZE; }
  uint8_t get(size_t i) const { return bytes_[i]; }

 private:
  const uint8_t* bytes_;
};

class ALEScreen {
 public:
  int height() const { return stub::H; }
  int width() const { return stub::W; }
};

class MediaSource {
 public:
  uint8_t prev_[stub::H * stub::W];
  uint8_t cur_[stub::H * stub::W];
  const uint8_t* previousFrameBuffer() const { return prev_; }
  const uint8_t* currentFrameBuffer() const { return cur_; }
};

class Console {
 public:
  MediaSource& mediaSource() { return media_; }
  MediaSource media_;
};

class OSystem {
 public:
  Console& console() { return console_; }
  Console console_;
};

class ALEInterface {
 public:
  std::unique_ptr<OSystem> theOSystem = std::make_unique<OSystem>();

  void setFloat(const std::string&, float) {}
  void setInt(const std::string&, int) {}
  void loadROM(const std::string& rom) { rom_ = rom; reset_game(); }

  void reset_game() {
    frame_ = 0;
    lives_ = stub::LIVES;
    game_over_ = false;
    render();
  }

  // deterministic scripted game: +1 reward every 7th frame; one life lost
  // every FRAMES_PER_LIFE frames; game over when lives run out
  float act(Action a) {
    if (game_over_) return 0.f;
    frame_++;
    last_action_ = a;
    if (frame_ % stub::FRAMES_PER_LIFE == 0) {
      lives_--;
      if (lives_ <= 0) game_over_ = true;
    }
    render();
    return (frame_ % 7 == 0) ? 1.f : 0.f;
  }

  bool game_over() const { return game_over_; }
  int lives() const { return lives_; }
  int getEpisodeFrameNumber() const { return frame_; }
  const ALEScreen& getScreen() const { return screen_; }

  std::vector<Action> getMinimalActionSet() {
    return {PLAYER_A_NOOP, PLAYER_A_FIRE, 3, 4};  // NOOP FIRE RIGHT LEFT
  }

  ALERAM getRAM() {
    ram_[0] = (uint8_t)(frame_ & 0xff);
    ram_[1] = (uint8_t)((frame_ >> 8) & 0xff);
    ram_[2] = (uint8_t)lives_;
    ram_[3] = (uint8_t)last_action_;
    return ALERAM(ram_);
  }

 private:
  void render() {
    auto& m = theOSystem->console().mediaSource();
    for (int i = 0; i < stub::H * stub::W; ++i) {
      m.prev_[i] = (uint8_t)((frame_ - 1 + i) & 0xff);
      m.cur_[i] = (uint8_t)((frame_ + i) & 0xff);
    }
  }

  std::string rom_;
  int frame_ = 0, lives_ = stub::LIVES, last_action_ = 0;
  bool game_over_ = false;
  ALEScreen screen_;
  uint8_t ram_[stub::RAM_SIZE] = {0};
};

}  // namespace ale
